"""Distribution over vertex shards: walker routing (mailbox all-to-all),
the super-step walker relay (exact cross-shard whole walks) and its
seeded fault-injection harness, on the ranks of a ``torch.distributed``
process group."""

from repro_torch.distributed.chaos import (ChaosReport, ChaosSchedule,
                                           run_chaos_relay)
from repro_torch.distributed.relay import (RelayIntegrityError, make_relay,
                                           relay_local, relay_view, stitch)
from repro_torch.distributed.walker_exchange import exchange_walkers

__all__ = ["exchange_walkers", "relay_local", "relay_view", "make_relay",
           "stitch", "ChaosReport", "ChaosSchedule", "RelayIntegrityError",
           "run_chaos_relay"]

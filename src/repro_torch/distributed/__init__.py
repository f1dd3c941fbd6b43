"""Distribution over vertex shards: walker routing (mailbox all-to-all),
the super-step walker relay (exact cross-shard whole walks) and its
seeded fault-injection harness, on the ranks of a ``torch.distributed``
process group or of a 2D vertex × walker ``DeviceMesh``; the LM's
sharding rules and gradient compression."""

from repro_torch.distributed.chaos import (ChaosReport, ChaosSchedule,
                                           make_chaos_relay,
                                           run_chaos_across_regrow,
                                           run_chaos_relay)
from repro_torch.distributed.relay import (RelayIntegrityError, RelayLayout,
                                           make_relay, relay_layout,
                                           relay_local, relay_view, stitch)
from repro_torch.distributed.sharding import (batch_pspec, cache_pspecs,
                                              fsdp_axes, param_pspecs,
                                              placements)
from repro_torch.distributed.walker_exchange import exchange_walkers

__all__ = ["param_pspecs", "batch_pspec", "cache_pspecs", "fsdp_axes",
           "placements", "exchange_walkers", "relay_local", "relay_view", "make_relay",
           "relay_layout", "RelayLayout", "stitch", "ChaosReport",
           "ChaosSchedule", "RelayIntegrityError", "make_chaos_relay",
           "run_chaos_relay", "run_chaos_across_regrow"]

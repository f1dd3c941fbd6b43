"""Crash-exact serving recovery: snapshots + a write-ahead log.

Port of ``repro/serve/recovery.py`` (DESIGN.md §11).  A
``DynamicWalkEngine`` updates one ``BingoState`` in place through every
round — fast, but a crash loses the graph.  This module makes the
serving loop recoverable, bit for bit:

* **Write-ahead log** (``WriteAheadLog``): every update round is appended
  — atomically, append-*before*-apply — as a sequenced ``<seq>.npz``
  record (``round``, ``walks`` or ``regrow``; the reference's records,
  so each package reads the other's log).  A ``walks`` record counts the
  walk seeds drawn from the engine's generator (``splits``) and the
  walks served.
* **Generation-stamped snapshots** via ``train/checkpoint``: the
  ``AsyncCheckpointer`` writes the host copy of the state plus a
  manifest ``extra`` with the WAL position ("generation"), the engine's
  ``torch.Generator`` state (where the reference stores its key data),
  the serving counters, the guard's books and the ladder tier.  The host
  copy is taken before serving continues, so the in-place updates that
  follow never reach the snapshot.
* **Restore = snapshot + WAL replay** (``RecoverableEngine.restore``):
  the manifest's tier picks the config before the state is read, the
  engine is rebuilt from the snapshot, every WAL round past its
  generation is re-ingested through the same guarded path, one seed is
  drawn per logged walk, and a logged regrow runs once.  Whole walks key
  their draws by (seed, walker, step) alone, so the restored engine's
  next walk equals the uninterrupted run's.

Over a sharded engine (``DynamicWalkEngine(group=...)``) every rank
wraps its own engine and makes the same calls.  A snapshot is the whole
state, gathered to group rank 0 and written by it alone in the
reference's layout (so either package reads it), with a barrier around
the write; only rank 0 appends WAL records, while every rank keeps the
sequence.  ``restore(..., group=...)``: every rank reads the snapshot,
keeps its rows and replays the WAL through the collective ``ingest``,
``walk`` seeds and ``regrow``.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dyngraph import BingoConfig, empty_state
from repro_torch.core.walks import WalkParams
from repro_torch.serve.dynwalk import DynamicWalkEngine, _host
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)

__all__ = ["WriteAheadLog", "RecoverableEngine"]

class WriteAheadLog:
    """Sequenced, atomic, append-only log of serving events.

    One ``<seq>.npz`` per record (``os.replace`` commit — a torn write
    leaves only an ignored ``.tmp`` file, and by append-before-apply a
    missing tail record is a round that was never applied).  Record
    kinds: ``round`` (is_insert/u/v/w arrays of one coalesced update
    round), ``walks`` (``splits`` seeds drawn from the engine's
    generator, serving ``served`` walks) and ``regrow``.  With
    ``write=False`` appends only advance the sequence (the ranks of a
    sharded engine other than rank 0).
    """

    def __init__(self, wal_dir: str, write: bool = True):
        self.wal_dir = wal_dir
        self.write = write
        os.makedirs(wal_dir, exist_ok=True)
        seqs = self._seqs()
        self.next_seq = (seqs[-1] + 1) if seqs else 0

    def _seqs(self):
        return sorted(
            int(f.split(".")[0]) for f in os.listdir(self.wal_dir)
            if f.endswith(".npz") and ".tmp" not in f)

    def _append(self, **payload) -> int:
        seq = self.next_seq
        self.next_seq = seq + 1
        if not self.write:
            return seq
        final = os.path.join(self.wal_dir, f"{seq:010d}.npz")
        tmp = final + f".tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)                 # atomic commit
        return seq

    def append_round(self, is_insert, u, v, w) -> int:
        """One update round; arrays or tensors (copied to the host)."""
        return self._append(kind=np.asarray("round"),
                            is_insert=_host(is_insert).astype(bool),
                            u=_host(u).astype(np.int32),
                            v=_host(v).astype(np.int32),
                            w=_host(w))

    def append_walks(self, splits: int, served: int) -> int:
        return self._append(kind=np.asarray("walks"),
                            splits=np.asarray(splits, np.int64),
                            served=np.asarray(served, np.int64))

    def append_regrow(self, tier: int) -> int:
        """One capacity-ladder escalation (DESIGN.md §14).  Logged
        append-before-apply like rounds: a crash between the append and
        the migration replays the regrow exactly once, a crash before
        the append leaves no record and the pressure trigger simply
        re-fires — the restored state is never half-migrated."""
        return self._append(kind=np.asarray("regrow"),
                            tier=np.asarray(tier, np.int64))

    def replay(self, from_seq: int = 0) -> Iterator[Tuple[int, str, dict]]:
        """Yield ``(seq, kind, payload)`` for records with seq >= from_seq."""
        for seq in self._seqs():
            if seq < from_seq:
                continue
            with np.load(os.path.join(self.wal_dir,
                                      f"{seq:010d}.npz")) as z:
                payload = {k: z[k] for k in z.files if k != "kind"}
                yield seq, str(z["kind"]), payload


class RecoverableEngine:
    """WAL + snapshot wrapper around a ``DynamicWalkEngine``.

    Same serving surface (``ingest`` / ``walk``); every mutation is
    logged before it is applied, and ``checkpoint_every=k`` snapshots
    the full state every k ingested rounds (0 = only on explicit
    ``checkpoint()`` calls).  A baseline generation-0 snapshot is
    written at construction so restore always has an anchor.
    """

    def __init__(self, engine: DynamicWalkEngine, *, ckpt_dir: str,
                 wal_dir: Optional[str] = None, checkpoint_every: int = 0,
                 keep: int = 3, _snapshot_now: bool = True):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.wal_dir = wal_dir or os.path.join(ckpt_dir, "wal")
        self.wal = WriteAheadLog(self.wal_dir, write=engine.rank == 0)
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep=keep,
                                      group=engine.group)
        self.checkpoint_every = checkpoint_every
        self._rounds_since_snapshot = 0
        if _snapshot_now:
            self.checkpoint()

    # -- serving surface (mirrors DynamicWalkEngine) -----------------------
    @property
    def state(self):
        return self.engine.state

    def ingest(self, is_insert, u, v, w):
        self.wal.append_round(is_insert, u, v, w)   # append BEFORE apply
        stats = self.engine.ingest(is_insert, u, v, w)
        self._rounds_since_snapshot += 1
        if (self.checkpoint_every
                and self._rounds_since_snapshot >= self.checkpoint_every):
            self.checkpoint()
        return stats

    def walk(self, starts, seed: Optional[int] = None):
        if seed is None:                     # draws from the generator
            self.wal.append_walks(1, int(starts.shape[0]))
        return self.engine.walk(starts, seed=seed)

    def regrow(self) -> BingoConfig:
        """Escalate the capacity ladder, WAL-logged append-before-apply
        (see ``WriteAheadLog.append_regrow`` for the crash contract)."""
        self.wal.append_regrow(self.engine.tier + 1)
        return self.engine.regrow()

    # -- snapshot / restore ------------------------------------------------
    def checkpoint(self) -> int:
        """Write a generation-stamped snapshot; returns its generation.

        Generation g means "WAL records 0..g-1 are folded into this
        snapshot"; restore replays records with seq >= g.
        """
        e = self.engine
        gen = self.wal.next_seq
        extra = {
            "generation": gen,
            "rounds_ingested": e.rounds_ingested,
            "updates_applied": e.updates_applied,
            "walks_served": e.walks_served,
            "generator_state": e._gen.get_state().tolist(),
            "guard": e.guard.snapshot() if e.guard is not None else None,
            "tier": e.cfg.tier,
            "regrow_counts": list(e.regrow_counts),
        }
        self.ckpt.save(gen, e.gather_state(dst=0), extra)
        self._rounds_since_snapshot = 0
        return gen

    def wait(self):
        self.ckpt.wait()

    @classmethod
    def restore(cls, ckpt_dir: str, cfg: BingoConfig,
                params: WalkParams = WalkParams(), *,
                wal_dir: Optional[str] = None, checkpoint_every: int = 0,
                keep: int = 3, device="cuda",
                **engine_kwargs) -> "RecoverableEngine":
        """Snapshot + WAL replay -> a bit-identical serving engine on
        ``device``.

        ``engine_kwargs`` go to ``DynamicWalkEngine`` (backend, guard,
        walk_buckets, group, ...) and must match the crashed engine's
        construction for the bit-exactness pin to hold.  With ``group=``
        every rank of the group calls this.
        """
        gen = latest_step(ckpt_dir)
        if gen is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        # The manifest decides the snapshot's ladder tier BEFORE the
        # state is read — its buffer shapes are the tier's, not the base
        # config's (a snapshot taken after a regrow is at C', and a
        # crash mid-regrow restores the pre-regrow tier + a WAL regrow
        # record, never a half-migrated state).
        with open(os.path.join(ckpt_dir, f"step_{gen}",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        tier = int(extra.get("tier", cfg.tier))
        cfg_run = cfg.tier_config(tier)
        state = restore_checkpoint(ckpt_dir, gen,
                                   like=empty_state(cfg_run, "meta"),
                                   device=device)

        engine = DynamicWalkEngine(state, cfg_run, params, **engine_kwargs)
        engine._gen.set_state(torch.tensor(extra["generator_state"],
                                           dtype=torch.uint8))
        engine.rounds_ingested = int(extra["rounds_ingested"])
        engine.updates_applied = int(extra["updates_applied"])
        engine.walks_served = int(extra["walks_served"])
        if "regrow_counts" in extra:
            engine.regrow_counts = [int(c)
                                    for c in extra["regrow_counts"]]
        if engine.guard is not None and extra["guard"] is not None:
            engine.guard.load_snapshot(extra["guard"])

        rec = cls(engine, ckpt_dir=ckpt_dir, wal_dir=wal_dir,
                  checkpoint_every=checkpoint_every, keep=keep,
                  _snapshot_now=False)
        for _seq, kind, p in rec.wal.replay(from_seq=gen):
            if kind == "round":
                engine.ingest(p["is_insert"], p["u"], p["v"], p["w"])
            elif kind == "walks":
                for _ in range(int(p["splits"])):
                    engine._next_seed()
                engine.walks_served += int(p["served"])
            elif kind == "regrow":
                engine.regrow()       # exactly-once: logged pre-apply
        return rec

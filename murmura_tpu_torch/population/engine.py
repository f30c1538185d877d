"""Cohort streaming (the PyTorch counterpart of
murmura_tpu/population/engine.py): a virtual population far larger than
the node axis, one cohort of N users on the card at a time.

:class:`PopulationNetwork` is a :class:`~murmura_tpu_torch.core.network.
Network` whose N node slots host a cohort drawn every
``rounds_per_cohort`` rounds from ``virtual_size`` users:

- the round program is the plain N-node program: cohort membership reaches
  it as values (the parameter rows, and with ``data_binding: user`` each
  slot's data rows, the shard ``user mod N``, passed through
  ``train_step(data=)`` and ``eval_step(data=)``; the program's own data
  is never changed);
- each user's parameter row lives in a host-side
  :class:`~murmura_tpu_torch.population.bank.PopulationBank` between
  activations (in RAM, or a sparse memory map past 256 MiB);
- draws are a pure function of ``(population.seed, draw_index)``
  (population/sampler.py), so a resumed run needs no sampler state;
- the swap is double-buffered: while round r runs on the card, the host
  gathers round r+1's cohort rows from the bank into pinned memory and
  starts their copy to the card (``non_blocking``); the pinned buffers
  ride the prefetch until the swap has used the rows (and the caching host
  allocator keeps a freed pinned block until its copy is done).  The one
  forced
  synchronisation of a swap is the write-back of the outgoing cohort,
  which sits between rounds, outside ``tpu.transfer_guard``'s region.

A user's first activation takes, under ``inherit: teleport``, the
outgoing cohort's trained row of the slot it lands in (composed on the
card, ``torch.where(known, rows, current)``), under ``slot_init`` the
slot's initial row.  The bank stores float32 rows whatever the resident
parameter dtype: bfloat16 → float32 → bfloat16 is exact, and the slot
inits are taken from the program's ``init_flat`` in its own dtype.
"""

import contextlib
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from murmura_tpu_torch.analysis.sanitizers import RecompileError, transfer_sanitizer
from murmura_tpu_torch.core.network import Network, _host_rows
from murmura_tpu_torch.core.rounds import round_generators
from murmura_tpu_torch.ops import _build
from murmura_tpu_torch.population.bank import PopulationBank
from murmura_tpu_torch.population.sampler import draw_cohort


@dataclass(frozen=True)
class PopulationSpec:
    """The ``population:`` section (config/schema.py PopulationConfig)."""

    virtual_size: int
    sampler: str = "uniform"
    seed: int = 1234
    rounds_per_cohort: int = 1
    data_binding: str = "user"
    bank_dir: Optional[str] = None
    # A fresh user's first row: "teleport" (the outgoing cohort's trained
    # row of its slot) or "slot_init" (the slot's initial row).
    inherit: str = "teleport"


class PopulationNetwork(Network):
    """A Network whose node axis hosts a cohort of a larger virtual
    population; ``Network``'s arguments plus ``population``."""

    def __init__(self, *args, population: PopulationSpec, **kwargs):
        super().__init__(*args, **kwargs)
        self.population = population
        n = self.program.num_nodes
        if population.virtual_size < n:
            raise ValueError(f"virtual_size={population.virtual_size} < cohort size {n}")
        # A user's first activation starts from its slot's initial row.
        self._slot_init = self.program.init_flat.to(torch.float32).cpu().numpy()
        self.bank = PopulationBank(population.virtual_size, self.program.model_dim,
                                   dtype=np.float32, directory=population.bank_dir)
        # Set once THIS instance flushed its bank into a snapshot: the
        # credential of an in-place restore (a new process must reattach
        # the flushed file instead).
        self._bank_flushed_here = False
        # The slots' data rows: the program's own until the first swap.
        self._data = self.program.data
        self.cohort: Optional[np.ndarray] = None
        self.cohorts_seen = 0
        # (draw index, cohort, rows, known, pinned host buffers)
        self._prefetched = None
        # Each swap's host seconds (the ``cohort`` event's swap_s).
        self.swap_times: List[float] = []

    # ------------------------------------------------------------------

    def _draw(self, draw_idx: int) -> np.ndarray:
        p = self.population
        return draw_cohort(p.sampler, p.virtual_size, self.program.num_nodes, draw_idx, p.seed)

    def _stage_cohort_rows(self, cohort: np.ndarray):
        """(rows, known, host buffers) of a cohort on the card: its banked
        rows (the slot inits where unbanked) in the parameter dtype and the
        [N, 1] banked mask.  On the card the copies start from pinned
        buffers without waiting; the caller holds the buffers until the
        swap has used the rows."""
        rows = torch.from_numpy(self.bank.gather(cohort, self._slot_init))
        known = torch.from_numpy(self.bank.has_rows(cohort)[:, None])
        if self.device.type == "cuda":
            rows, known = rows.pin_memory(), known.pin_memory()
        host = (rows, known)
        dev_rows = rows.to(self.device, non_blocking=True).to(self.program.init_flat.dtype)
        dev_known = known.to(self.device, non_blocking=True)
        return dev_rows, dev_known, host

    def _prefetch(self, draw_idx: int) -> None:
        """Stage the next cohort while the current round runs: the bank
        gather on the host and the asynchronous copy to the card overlap
        the queued round."""
        cohort = self._draw(draw_idx)
        self._prefetched = (draw_idx, cohort, *self._stage_cohort_rows(cohort))

    def _rebind_data(self, cohort: np.ndarray) -> None:
        """``data_binding: user``: each slot trains, probes and evaluates on
        the shard of its user id (``user mod N``)."""
        n = self.program.num_nodes
        shard = torch.from_numpy(cohort % n).to(self.device)
        self._data = {k: v.index_select(0, shard) if v.dim() >= 1 and v.shape[0] == n else v
                      for k, v in self.program.data.items()}

    def _swap_to(self, draw_idx: int, round_idx: int) -> None:
        t0 = time.perf_counter()
        if self._prefetched is not None and self._prefetched[0] == draw_idx:
            _, cohort, dev_rows, dev_known, _host = self._prefetched
        else:
            cohort = self._draw(draw_idx)
            dev_rows, dev_known, _host = self._stage_cohort_rows(cohort)
        self._prefetched = None

        outgoing = self.flat
        swapped_out = 0
        if self.cohort is not None:
            # The write-back: the one forced synchronisation of a swap.
            self.bank.scatter(self.cohort, outgoing.to(torch.float32).cpu().numpy())
            swapped_out = len(self.cohort)
            # The incoming rows were staged before this write-back (the
            # overlap), so a user in both cohorts was staged one swap stale
            # (or as unbanked): stage again from the current bank.  Rare at
            # a large virtual_size, needed for correctness at a small one.
            if np.intersect1d(self.cohort, cohort).size:
                dev_rows, dev_known, _host = self._stage_cohort_rows(cohort)

        if self.population.inherit == "teleport":
            # Banked users resume their own row, fresh ones the outgoing
            # cohort's trained row of their slot (before the first swap the
            # slot inits themselves).
            self.flat = torch.where(dev_known, dev_rows, outgoing)
        else:
            self.flat = dev_rows
        if self.population.data_binding == "user":
            self._rebind_data(cohort)
        self.cohort = cohort
        self.cohorts_seen += 1
        swap_s = time.perf_counter() - t0
        self.swap_times.append(swap_s)
        if self.telemetry is not None:
            self.telemetry.emit(
                "cohort", round=round_idx, draw=draw_idx, swapped_out=swapped_out,
                activated_users=self.bank.activated,
                virtual_size=self.population.virtual_size, swap_s=round(swap_s, 6),
            )

    # ------------------------------------------------------------------

    def _train_chunks(self, rounds, verbose, eval_every, rounds_per_dispatch, checkpoint_dir,
                      checkpoint_every) -> None:
        """The cohort-streaming round loop, one round a dispatch (the swap
        is a host decision between rounds).  A snapshot on the cadence is
        taken as the bank stands, the resident cohort's rows riding the
        parameters, so that the restored bank is the uninterrupted run's;
        the resident cohort is written back when the loop ends (it stays
        loaded for a later ``train`` call)."""
        if rounds_per_dispatch > 1:
            warnings.warn(
                "population streaming dispatches per round (the cohort swap is a "
                "host decision between rounds); rounds_per_dispatch is ignored",
                stacklevel=3,
            )
        rpc = self.population.rounds_per_cohort
        cuda = self.device.type == "cuda"
        last_saved = -1
        for step_i in range(rounds):
            round_idx = self.current_round
            if round_idx % rpc == 0 or self.cohort is None:
                self._swap_to(round_idx // rpc, round_idx)
            self._profile_window_start(round_idx)
            t0 = time.perf_counter()
            warmup = "step" not in self._warmed
            builds = len(_build.STARTED)
            adj, alive = self._stage([round_idx])
            guard = (transfer_sanitizer if self.transfer_guard and not warmup and cuda
                     else contextlib.nullcontext)
            with guard():
                self.flat, self.agg_state, metrics = self.program.train_step(
                    self.flat, self.agg_state, adj[0], self._comp, float(round_idx),
                    generators=round_generators(self.seed, round_idx, self.device),
                    alive=None if alive is None else alive[0], data=self._data,
                )
            self._warmed.add("step")
            self.current_round = round_idx + 1
            # The round is queued: stage the next cohort behind it.
            if step_i + 1 < rounds and self.current_round % rpc == 0:
                self._prefetch(self.current_round // rpc)
            evaluated = self.current_round % eval_every == 0
            rows = []
            if evaluated:
                with guard():
                    rows = [(self.current_round,
                             {**self.program.eval_step(self.flat, data=self._data), **metrics})]
            rows = _host_rows(rows)
            self._sync()
            wall = time.perf_counter() - t0
            self.round_times.append(wall)
            if self.telemetry is not None:
                self.telemetry.phase_times(round_idx, "population", wall, evaluated=evaluated,
                                           cohort_draw=round_idx // rpc)
                self.telemetry.memory_event(round_idx, self.device)
                self._profile_window_stop(self.current_round)
            for round_num, m in rows:
                self._record(round_num, m, verbose)
            if self.recompile_guard and not warmup and len(_build.STARTED) > builds:
                raise RecompileError(
                    f"tpu.recompile_guard: kernel build(s) {_build.STARTED[builds:]} "
                    f"started in round {round_idx}, after the first round"
                )
            if checkpoint_dir and checkpoint_every and self.current_round % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_dir)
                last_saved = self.current_round
        if self.cohort is not None and rounds > 0:
            self.bank.scatter(self.cohort, self.flat.to(torch.float32).cpu().numpy())
        if checkpoint_dir and rounds > 0 and self.current_round != last_saved:
            self.save_checkpoint(checkpoint_dir)

    # ------------------------------------------------------------------
    # durability hooks (durability/snapshot.py)

    def _durability_extra_state(self):
        """The streaming state beyond the base sections: the resident
        cohort, the swap count and the bank.  ``external`` bank mode
        (``population.bank_dir``): the memory map is flushed in place and
        only the packed activation mask rides the snapshot; ``embedded``
        (a RAM or temporary bank, which dies with the process): the
        activated ids and rows are copied into it.  The sampler has no
        state: draw ``round // rounds_per_cohort`` is a pure function."""
        from murmura_tpu_torch.durability.snapshot import embed_bool_mask

        arrays, meta = super()._durability_extra_state()
        p = self.population
        external = p.bank_dir is not None
        if external:
            self.bank.flush()
            self._bank_flushed_here = True
        else:
            ids = self.bank.activated_users
            arrays["population/bank_user_ids"] = ids
            arrays["population/bank_rows"] = self.bank.rows_of(ids)
        arrays["population/bank_has_row"] = embed_bool_mask(self.bank._has_row)
        if self.cohort is not None:
            arrays["population/cohort"] = np.asarray(self.cohort, np.int64)
        meta["population"] = {
            "virtual_size": p.virtual_size,
            "sampler": p.sampler,
            "seed": p.seed,
            "rounds_per_cohort": p.rounds_per_cohort,
            "data_binding": p.data_binding,
            "inherit": p.inherit,
            "cohorts_seen": self.cohorts_seen,
            "bank_mode": "external" if external else "embedded",
            "bank_path": self.bank.path,
            "activated": self.bank.activated,
        }
        return arrays, meta

    def _durability_validate_extra(self, arrays, meta) -> None:
        pm = meta.get("population")
        if pm is None or "population/bank_has_row" not in arrays:
            raise ValueError(
                "snapshot carries no population section — it was written by a plain "
                "run; drop the population block or point --checkpoint-dir at a "
                "population snapshot"
            )
        if "gang" in meta:
            raise ValueError("snapshot was written by a gang; rebuild with the matching config")
        p = self.population
        mismatched = {
            k: (pm.get(k), getattr(p, k))
            for k in ("virtual_size", "sampler", "seed", "rounds_per_cohort", "data_binding",
                      "inherit")
            if pm.get(k) != getattr(p, k)
        }
        if mismatched:
            raise ValueError(
                "population snapshot/config mismatch (snapshot vs config): "
                f"{mismatched} — the cohort stream would silently diverge from the "
                "interrupted run"
            )
        if pm["bank_mode"] == "external":
            # The flushed file is the snapshot's row data: it must be the
            # file the snapshot recorded, and the live memory map must be
            # that file's data (reattached by a new process, or flushed by
            # this very instance).
            if self.bank.path != pm["bank_path"]:
                raise ValueError(
                    f"population snapshot records its memmapped bank at "
                    f"{pm['bank_path']!r} but this config's bank_dir={p.bank_dir!r} "
                    f"opens {self.bank.path!r} — resuming onto a different bank file "
                    "would continue from some other run's rows; keep the bank at the "
                    "path the snapshot recorded"
                )
            if not (self.bank.reattached or self._bank_flushed_here):
                raise ValueError(
                    f"population snapshot expects the memmapped bank at "
                    f"{pm['bank_path']!r} but no matching bank file was found under "
                    f"bank_dir={p.bank_dir!r} — the flushed rows are the snapshot's "
                    "data; restore them first"
                )

    def _durability_restore_extra(self, arrays, meta) -> None:
        from murmura_tpu_torch.durability.snapshot import unpack_bool_mask

        pm = meta["population"]
        p = self.population
        host = {k: v.cpu().numpy() for k, v in arrays.items()}
        if pm["bank_mode"] != "external":
            ids = host["population/bank_user_ids"]
            if len(ids):
                self.bank.scatter(ids, host["population/bank_rows"])
        self.bank.restore_activation(
            unpack_bool_mask(host["population/bank_has_row"], p.virtual_size))
        self.cohorts_seen = int(pm["cohorts_seen"])
        self._prefetched = None
        cohort = host.get("population/cohort")
        self.cohort = None if cohort is None else np.asarray(cohort, np.int64)
        if self.cohort is not None and p.data_binding == "user":
            # The restored parameters are the resident cohort's rows: they
            # train on the shards they trained on before the interruption.
            self._rebind_data(self.cohort)


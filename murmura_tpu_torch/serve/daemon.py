# Copy of TERMINAL_STATES, _jsonable, SubmissionError, normalize_submission
# and ServeDaemon from murmura_tpu/serve/daemon.py.
"""``python -m murmura_tpu_torch serve <yaml>``: the crash-surviving
multi-tenant daemon.

The daemon multiplexes experiments submitted one by one onto warm gang
buckets (core/gang.py):

- **Admission key = the structural fingerprint**
  (:func:`serve.scheduler.structural_fingerprint`).  Submissions whose
  configs differ only in experiment seed and name and ``training.lr``
  share one bucket.
- **A bucket is built once**, with ``min_batch = serve.capacity``, and
  every generation of 1..capacity tenants is a value-only
  ``GangNetwork.reset_run(member_programs=...)`` splice into its lanes: it
  builds no chunk program and starts no ``nvcc`` build.  More than
  ``capacity`` queued tenants of one fingerprint form several generations
  through the same bucket.
- **Eviction = ``freeze_member``.**  An evicted tenant's lane stops
  recording and keeps computing, so the survivors are untouched.  The
  ledger's ``evicted`` is immediate; the lane freezes at the gang's next
  chunk boundary (``GangNetwork.request_freeze``), before that chunk's rows
  are recorded, and the tenant's stream gets its ``evicted`` event when
  the generation ends.
- **Crash survival is the ledger and the snapshot.**  Every submission is
  a durably written ``submissions/<id>.json`` record (queued -> running
  -> done/failed/evicted); every generation writes its members to
  ``buckets/<fp>/gen_<n>/generation.json`` before training starts and
  snapshots the whole gang every ``serve.checkpoint_every`` rounds
  (durability/snapshot.py).  The record also names the bucket's template
  tenant, whose config built the gang (its attack placement, topology and
  fault schedule).  After a SIGKILL, :meth:`recover` replays the ledger,
  rebuilds the bucket from that template and each generation that was
  running from the recorded tenant configs, restores its snapshot and runs
  the remaining rounds: the histories equal an uninterrupted daemon's (bit
  for bit on the CPU), in whichever generation the kill came.
- **Over a group.**  Where the daemon config's layout at ``capacity``
  lanes has a running world W above 1 (``factories.serve_plan``: a seed
  group, or a param group at ``tpu.param_shards`` > 1), ``serve`` starts W
  ranks once for the daemon's lifetime and every rank builds a daemon.
  Rank 0 owns the outside world: the socket, the ledger, the submission
  records and ``generation.json``.  It sends every rank each generation's
  composition (its tenants' configs, the template, whether it resumes from
  a snapshot), and every rank runs the generation as a gang over the
  group: a seed group's rank its block of the tenants, a param group's rank
  its column block of every tenant.  A tenant's telemetry writer lives on
  the rank that trains it (rank 0 over a param group); the ledger's
  histories are rank 0's, which records every tenant's.  While its queue is
  empty rank 0 sends a tick every ``serve.poll_interval_s``, so that the
  other ranks, waiting for its next message, never reach the group's
  collective timeout; the stop ends them.  A tenant whose own ``tpu``
  section plans another layout is refused at submission
  (``factories.check_serve_plan``).  A failed generation ends the group
  (its ranks could not agree on a retry); the ledger keeps it running, and
  the restarted daemon recovers it.

Threading: one listener thread (rank 0's) owns the unix socket and touches
the ledger and the queue under the lock; an eviction of a running tenant
queues its lane's freeze on the gang.  Every tensor, every CUDA call and
every collective stays on the thread that runs generations
(:meth:`serve_forever` / :meth:`drain`).  ``compiles`` (the lifetime
counter, and ``serve_compiles`` in a tenant's manifest) counts what a
generation built in the process: chunk programs plus ``nvcc`` builds.
"""

import json
import os
import socket
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from murmura_tpu_torch.config.schema import Config
from murmura_tpu_torch.durability.dispatch import (
    RetryPolicy,
    RetryStats,
    classify_error,
    run_with_retry,
)
from murmura_tpu_torch.serve.scheduler import (
    _NON_STRUCTURAL_SECTIONS,
    structural_fingerprint,
)

# Submission lifecycle states.  Terminal: done / failed / evicted.
TERMINAL_STATES = ("done", "failed", "evicted")


def _jsonable(obj):
    """History/metric payloads carry numpy scalars; flatten for JSON."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class SubmissionError(ValueError):
    """The submitted config cannot be served (refused at admission)."""


def normalize_submission(raw: Dict[str, Any],
                         check: Optional[Callable[[Config], None]] = None
                         ) -> Tuple[Config, str]:
    """Validate and normalize one submitted config; returns
    ``(config, fingerprint)``.

    Driver blocks are the daemon's job, not the tenant's: ``sweep``,
    ``frontier``, ``grid`` and ``serve`` sections are refused (a tenant is
    one experiment), the multi-process ``distributed`` backend is refused
    (its lifecycle cannot ride a gang lane), and the telemetry and
    durability sections are dropped: the daemon owns both.  ``check`` (the
    daemon's) refuses a tenant whose planned layout is not the daemon's; its
    ConfigError becomes the SubmissionError.
    """
    if not isinstance(raw, dict):
        raise SubmissionError(
            f"submission config must be a mapping, got {type(raw).__name__}"
        )
    for section in ("sweep", "frontier", "grid", "serve"):
        if raw.get(section) is not None:
            raise SubmissionError(
                f"submission carries a '{section}' section — a tenant is "
                "one experiment; the daemon owns multiplexing"
            )
    raw = dict(raw)
    for section in _NON_STRUCTURAL_SECTIONS:
        raw.pop(section, None)
    try:
        config = Config.model_validate(raw)
    except Exception as e:  # noqa: BLE001 — the client gets the real reason
        raise SubmissionError(f"submission config invalid: {e}") from e
    if config.backend == "distributed":
        raise SubmissionError(
            "backend=distributed cannot be served — the ZMQ process "
            "lifecycle does not fit a gang lane; submit simulation or tpu"
        )
    if check is not None:
        from murmura_tpu_torch.utils.factories import ConfigError

        try:
            check(config)
        except ConfigError as e:
            raise SubmissionError(str(e)) from None
    config.experiment.verbose = False
    return config, structural_fingerprint(config)


def _group_axis(group) -> Tuple[Optional[str], int]:
    """(axis, world) of the group this process runs in ((None, 1) outside
    one)."""
    from murmura_tpu_torch.parallel.mesh import NodeGroup, SeedGroup

    if group is None:
        return None, 1
    axis = "seed" if isinstance(group, SeedGroup) else (
        "nodes" if isinstance(group, NodeGroup) else "param")
    return axis, group.world


class ServeDaemon:
    """The experiment daemon behind ``serve <yaml>``; its gangs run on
    ``device``, over the seed or param group this process is a rank of
    (parallel/launch.py), which must be the group the config plans."""

    def __init__(self, config: Config, device="cuda"):
        if config.serve is None:
            raise ValueError(
                "murmura serve needs a `serve:` section (state_dir at "
                "minimum) in the daemon config"
            )
        from murmura_tpu_torch.parallel.mesh import SeedGroup, process_group
        from murmura_tpu_torch.utils.factories import check_serve_plan, serve_plan

        s = config.serve
        self.config = config
        self.device = device
        self.capacity = int(s.capacity)
        self.checkpoint_every = int(s.checkpoint_every)
        self.poll_interval_s = float(s.poll_interval_s)
        self.state_dir = Path(s.state_dir).resolve()
        self.socket_path = str(
            s.socket if s.socket else self.state_dir / "daemon.sock"
        )
        # The group the daemon runs over: the config's plan at capacity
        # lanes must be the process's group.  Ranks sharing one card stand
        # for as many cards (the one-device seam).
        self.group = process_group()
        self._device_type = str(device).split(":")[0]
        self._cards = (self.group.world if self.group is not None and self.group.staged
                       else None)
        check_serve_plan(config, self.capacity, self._device_type,
                         (None, *_group_axis(self.group)), self._cards,
                         who="the daemon's config",
                         remedy="start the daemon with `serve`, which launches the ranks of "
                                "the group its config plans")
        self.plan = serve_plan(config, self.capacity, self._device_type, self._cards)
        self._owner = self.group is None or self.group.rank == 0
        self._seeds = self.group if isinstance(self.group, SeedGroup) else None
        if self._owner:
            (self.state_dir / "submissions").mkdir(parents=True, exist_ok=True)
            (self.state_dir / "buckets").mkdir(parents=True, exist_ok=True)

        self._lock = threading.RLock()
        self._ledger: Dict[str, Dict[str, Any]] = {}
        self._pending: List[str] = []
        # fp -> {"gang": GangNetwork, "gen": int, "lanes": {lane: id},
        #        "template": the id of the tenant whose config built it}
        self._buckets: Dict[str, Dict[str, Any]] = {}
        self._stop = threading.Event()
        self._listener: Optional[threading.Thread] = None
        self._server = None
        self._seq = 0
        # The observability plane: the process's lifetime counters (ping,
        # top's header, the metrics op).
        self.started_at = time.time()
        self._counters: Dict[str, int] = {
            "admissions": 0, "evictions": 0, "resumes": 0,
            "compiles": 0, "generations": 0,
        }
        if self._owner:
            self._load_ledger()

    # ------------------------------------------------------------------
    # Durable ledger

    def _record_path(self, sub_id: str) -> Path:
        return self.state_dir / "submissions" / f"{sub_id}.json"

    def _write_record(self, rec: Dict[str, Any]) -> None:
        from murmura_tpu_torch.utils.checkpoint import durable_replace

        durable_replace(
            self.state_dir / "submissions",
            f"{rec['id']}.json",
            (json.dumps(_jsonable(rec), indent=2) + "\n").encode("utf-8"),
        )

    def _update(self, sub_id: str, **fields) -> Dict[str, Any]:
        with self._lock:
            rec = self._ledger[sub_id]
            rec.update(fields)
            self._write_record(rec)
            return rec

    def _load_ledger(self) -> None:
        for path in sorted((self.state_dir / "submissions").glob("*.json")):
            with open(path, encoding="utf-8") as fh:
                rec = json.load(fh)
            self._ledger[rec["id"]] = rec
            num = rec["id"].rsplit("-", 1)[-1]
            if num.isdigit():
                self._seq = max(self._seq, int(num))
            if rec["state"] == "queued":
                self._pending.append(rec["id"])
        self._pending.sort()

    # ------------------------------------------------------------------
    # Admission

    def _check_tenant(self, config: Config) -> None:
        """Refuse a tenant whose plan at the daemon's capacity is not the
        daemon's."""
        from murmura_tpu_torch.utils.factories import check_serve_plan

        check_serve_plan(config, self.capacity, self._device_type, self.plan, self._cards)

    def submit_config(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Admit one submission (the in-process twin of the socket
        ``submit`` op); returns the durably-written ledger record."""
        config, fp = normalize_submission(raw, check=self._check_tenant)
        with self._lock:
            self._seq += 1
            sub_id = f"sub-{self._seq:05d}"
            rec = {
                "id": sub_id,
                "state": "queued",
                "fingerprint": fp,
                "config": config.model_dump(),
                "submitted_at": time.time(),
                "rounds": config.experiment.rounds,
            }
            self._ledger[sub_id] = rec
            self._write_record(rec)
            self._pending.append(sub_id)
            self._counters["admissions"] += 1
        return dict(rec)

    def evict(self, sub_id: str, reason: str = "evicted") -> Dict[str, Any]:
        """Evict a submission: a queued tenant never runs; a running
        tenant's lane freezes at its gang's next chunk boundary
        (``GangNetwork.request_freeze``: its history stops, the survivors
        are untouched)."""
        with self._lock:
            rec = self._ledger.get(sub_id)
            if rec is None:
                raise KeyError(f"unknown submission {sub_id}")
            if rec["state"] in TERMINAL_STATES:
                return dict(rec)
            if rec["state"] == "queued":
                self._pending = [i for i in self._pending if i != sub_id]
            elif rec["state"] == "running":
                bucket = self._buckets.get(rec["fingerprint"])
                if bucket is not None and rec.get("lane") is not None:
                    bucket["gang"].request_freeze(int(rec["lane"]), reason)
            self._counters["evictions"] += 1
            return dict(self._update(sub_id, state="evicted", error=reason))

    # ------------------------------------------------------------------
    # The group: rank 0's messages

    def _from_owner(self, value):
        """Rank 0's ``value`` on every rank (``value`` outside a group)."""
        if self.group is None:
            return value
        from murmura_tpu_torch.parallel.mesh import broadcast_object

        return broadcast_object(value, self.group)

    def _follow(self) -> None:
        """A rank other than 0: run each generation rank 0 announces until
        its stop (its ticks only keep the group's collectives alive)."""
        while True:
            msg = self._from_owner(None)
            if msg["op"] == "stop":
                return
            if msg["op"] == "generation":
                self._execute(msg)

    def _release(self) -> None:
        """Rank 0: send the other ranks the stop (nothing outside a group)."""
        if self.group is not None:
            self._from_owner({"op": "stop"})

    def _tick(self) -> None:
        """Rank 0, idle: keep the other ranks' wait short of the group's
        collective timeout."""
        if self.group is not None:
            self._from_owner({"op": "tick"})

    # ------------------------------------------------------------------
    # Buckets and generations

    def _member_for(self, config: Config):
        from murmura_tpu_torch.core.gang import GangMember

        # lr is set for every member, so the gang always passes each lane
        # its own: tenants with different lr share a bucket
        # (scheduler._MEMBER_LEAVES).
        return GangMember(
            seed=int(config.experiment.seed),
            lr=float(config.training.lr),
        )

    def _writer(self, sub_id: str, config: Config, resume: bool):
        from murmura_tpu_torch.telemetry.writer import TelemetryWriter

        return TelemetryWriter(
            str(self.state_dir / "telemetry" / sub_id),
            run_id=sub_id,
            config=config,
            phase_times=True,
            resume=resume,
        )

    def _ensure_bucket(self, fp: str, template_id: str, template: Config) -> Dict[str, Any]:
        """The warm bucket for fingerprint ``fp``, built on first use from
        tenant ``template_id``'s config ``template``: a 1-member template gang
        with ``min_batch=capacity``, so that every admission of up to
        ``capacity`` tenants is value-only.  Its freezes are taken at chunk
        boundaries (``GangNetwork.boundary_freezes``)."""
        from murmura_tpu_torch.utils.factories import build_gang_from_config

        with self._lock:
            bucket = self._buckets.get(fp)
            if bucket is not None:
                return bucket
        raw = template.model_dump()
        member = self._member_for(template)
        raw["sweep"] = {
            "members": [{"seed": member.seed, "lr": member.lr}]
        }
        template_cfg = Config.model_validate(raw)
        gang = build_gang_from_config(
            template_cfg, device=self.device, min_batch=self.capacity,
        )
        gang.boundary_freezes = True
        bucket = {"gang": gang, "gen": 0, "lanes": {}, "template": template_id}
        with self._lock:
            self._buckets[fp] = bucket
        return bucket

    def _gen_dir(self, fp: str, gen: int) -> Path:
        return self.state_dir / "buckets" / fp / f"gen_{gen}"

    def _next_generation(self) -> Optional[Tuple[str, List[str]]]:
        """The next generation to run: the oldest queued submission's
        fingerprint group, up to ``capacity`` tenants, FIFO."""
        with self._lock:
            if not self._pending:
                return None
            fp = self._ledger[self._pending[0]]["fingerprint"]
            ids = [
                i for i in self._pending
                if self._ledger[i]["fingerprint"] == fp
            ][: self.capacity]
            self._pending = [i for i in self._pending if i not in ids]
            return fp, ids

    def _run_generation(
        self,
        fp: str,
        ids: Sequence[str],
        *,
        gen: Optional[int] = None,
        resume: bool = False,
        template_id: Optional[str] = None,
    ) -> None:
        """Run one generation of bucket ``fp`` with tenants ``ids`` (rank 0,
        or the one process); a bucket not yet built is built from
        ``template_id``'s config (the recorded template on a recovery), else
        from the first tenant's.  Over a group the generation's message
        reaches every rank first, and every rank runs it
        (:meth:`_execute`)."""
        with self._lock:
            bucket = self._buckets.get(fp)
            if gen is None:
                gen = (bucket["gen"] if bucket is not None else 0) + 1
            if bucket is not None:
                template_id = bucket["template"]
            template_id = template_id or ids[0]
            msg = {
                "op": "generation", "fp": fp, "gen": gen, "ids": list(ids),
                "configs": [self._ledger[i]["config"] for i in ids],
                "submitted_at": [self._ledger[i].get("submitted_at") for i in ids],
                "template": [template_id, self._ledger[template_id]["config"]],
                "resume": resume,
                "snapshot": resume and (self._gen_dir(fp, gen) / "meta.json").exists(),
            }
        self._execute(self._from_owner(msg))

    def _block(self, count: int) -> Tuple[int, int]:
        """[lo, hi) of a generation's tenants this process trains: a seed
        group's rank its block, otherwise every tenant."""
        if self._seeds is None:
            return 0, count
        return self._seeds.bind(count).members()

    def _execute(self, msg: Dict[str, Any]) -> None:
        """Run one announced generation (every rank).  The composition
        record (``generation.json``) is durably written before any
        training, so that a SIGKILL at any later point leaves enough on
        disk to rebuild the gang and resume it."""
        from murmura_tpu_torch.utils.checkpoint import durable_replace
        from murmura_tpu_torch.utils.factories import build_gang_member_programs

        fp, gen, ids, resume = msg["fp"], int(msg["gen"]), list(msg["ids"]), msg["resume"]
        configs = [Config.model_validate(c) for c in msg["configs"]]
        template_id, template = msg["template"]
        bucket = self._ensure_bucket(fp, template_id, Config.model_validate(template))
        gang = bucket["gang"]
        gen_dir = self._gen_dir(fp, gen)
        rounds = int(configs[0].experiment.rounds)
        members = [self._member_for(cfg) for cfg in configs]
        if self._owner:
            gen_dir.mkdir(parents=True, exist_ok=True)
            if not resume:
                durable_replace(
                    gen_dir, "generation.json",
                    (json.dumps({
                        "fingerprint": fp,
                        "gen": gen,
                        "rounds": rounds,
                        "template": bucket["template"],
                        "submissions": [
                            {"id": i, "seed": m.seed, "lr": m.lr}
                            for i, m in zip(ids, members)
                        ],
                    }, indent=2) + "\n").encode("utf-8"),
                )
            with self._lock:
                for lane, sub_id in enumerate(ids):
                    self._update(
                        sub_id, state="running", bucket=fp, gen=gen, lane=lane,
                    )
        with self._lock:
            bucket["lanes"] = {lane: i for lane, i in enumerate(ids)}

        lo, hi = self._block(len(ids))
        progs = [
            build_gang_member_programs(cfg, [m], device=self.device, whole=True,
                                       attack=gang.attack)[0]
            for cfg, m in zip(configs[lo:hi], members[lo:hi])
        ]
        # A tenant's writer lives on the rank that trains it; over a param
        # group every rank trains every tenant and rank 0 writes.
        writes = self.group is None or self._seeds is not None or self._owner
        writers = {lane: self._writer(ids[lane], configs[lane], resume=resume)
                   for lane in (range(lo, hi) if writes else ())}
        # Lifecycle events through each tenant's own stream: the trace's
        # side of the ledger.  ``submitted`` is backdated to the ledger's
        # submitted_at: the writer exists from admission on, but the time
        # in the queue is real.
        compile_baseline = self._compile_count()
        for lane, w in writers.items():
            if not resume:
                w.serve_event("submitted", _t=msg["submitted_at"][lane], bucket=fp)
                w.serve_event("admitted", bucket=fp, gen=gen, lane=lane)
            else:
                w.serve_event("resumed", bucket=fp, gen=gen, lane=lane)
            w.serve_event("generation_start", gen=gen, lane=lane)
        with self._lock:
            if resume:
                self._counters["resumes"] += len(ids)
            self._counters["generations"] += 1
        gang.reset_run(
            members, member_programs=progs, telemetry_writers=list(writers.values()),
        )
        if msg["snapshot"]:
            gang.restore_checkpoint(str(gen_dir))

        def attempt(try_idx: int):
            if try_idx > 0 and (gen_dir / "meta.json").exists():
                # A failed attempt may have advanced the state: the restore
                # is the retry (durability/dispatch.py).
                gang.restore_checkpoint(str(gen_dir))
            remaining = rounds - gang.current_round
            if remaining > 0:
                gang.train(
                    rounds=remaining,
                    eval_every=1,
                    checkpoint_dir=str(gen_dir),
                    checkpoint_every=self.checkpoint_every,
                )
            return gang.histories

        retry_stats = RetryStats()

        def on_retry(exc, try_idx, delay):
            # The envelope's degradations land in every tenant's stream
            # (the metrics fold's murmura_degradations).
            retry_stats.hook(exc, try_idx, delay)
            for w in writers.values():
                w.emit(
                    "backend_degraded", kind="retry",
                    reason=retry_stats.last_reason, retry=try_idx,
                    delay_s=delay,
                )

        if self.group is not None:
            # A failure ends the group: its ranks could not agree on a retry.
            histories = attempt(0)
        else:
            try:
                histories = run_with_retry(
                    attempt,
                    policy=RetryPolicy(max_retries=2, base_delay_s=0.1,
                                       max_delay_s=1.0, seed=0),
                    classify=classify_error,
                    on_retry=on_retry,
                )
            except Exception as e:  # noqa: BLE001 — per-tenant fate recording
                for lane, sub_id in enumerate(ids):
                    if self._ledger[sub_id]["state"] == "running":
                        self._update(
                            sub_id, state="failed",
                            error=f"{type(e).__name__}: {e}",
                        )
                    writers[lane].serve_event(
                        "generation_done", gen=gen,
                        outcome=self._ledger[sub_id]["state"],
                    )
                self._finish_generation(
                    fp, gen, ids, writers.values(), compile_baseline, retry_stats,
                )
                return

        # Each tenant's fate, decided once under the lock (an eviction may
        # arrive until then): evicted (its stream's event now, on the rank
        # that holds it) or done with rank 0's history.
        evicted: Dict[int, Any] = {}
        if self._owner:
            with self._lock:
                for lane, sub_id in enumerate(ids):
                    rec = self._ledger[sub_id]
                    if rec["state"] != "running":
                        evicted[lane] = rec.get("error")
                        continue
                    hist = histories[lane]
                    mean = hist.get("mean_accuracy") or []
                    honest = hist.get("honest_accuracy") or mean
                    self._update(
                        sub_id,
                        state="done",
                        final_accuracy=float(mean[-1]) if mean else None,
                        honest_accuracy=float(honest[-1]) if honest else None,
                        history=_jsonable(hist),
                        phase_times={
                            "mode": "gang_per_round",
                            "rounds": rounds,
                            "mean_round_s": (
                                float(np.mean(gang.round_times))
                                if gang.round_times else 0.0
                            ),
                        },
                    )
        evicted = self._from_owner(evicted)
        for lane, w in writers.items():
            if lane in evicted:
                w.serve_event("evicted", reason=evicted[lane], gen=gen, lane=lane)
            else:
                w.serve_event("generation_done", gen=gen, outcome="done")
        self._finish_generation(
            fp, gen, ids, writers.values(), compile_baseline, retry_stats,
        )

    def _compile_count(self) -> int:
        """What this process's daemon has built: its buckets' chunk
        programs plus the ``nvcc`` builds started in the process
        (ops/_build.py)."""
        from murmura_tpu_torch.ops import _build

        with self._lock:
            gangs = [b["gang"] for b in self._buckets.values()]
        return sum(g.program_builds for g in gangs) + len(_build.STARTED)

    def _finish_generation(self, fp, gen, ids, writers,
                           compile_baseline, retry_stats=None) -> None:
        """Close the generation: add the build delta and the dispatch
        envelope's retry totals to each tenant's manifest, retire the live
        writers, and advance the bucket."""
        compiled = max(0, self._compile_count() - compile_baseline)
        for w in writers:
            if compiled:
                w.add_counters({"serve_compiles": compiled})
            if retry_stats is not None and retry_stats.retries:
                w.add_counters(retry_stats.counters())
            try:
                w.finalize()
                w.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        with self._lock:
            self._counters["compiles"] += compiled
            bucket = self._buckets.get(fp)
            if bucket is not None:
                bucket["gen"] = max(bucket["gen"], gen)
                bucket["lanes"] = {}

    # ------------------------------------------------------------------
    # Crash recovery

    def recover(self) -> List[str]:
        """Resume every generation that was running from its record on
        disk: rebuild the bucket from its recorded template tenant and the
        generation from the recorded tenant configs, restore the latest
        snapshot where one exists (on every rank of a group), and run the
        remaining rounds (or the whole generation when the kill came before
        the first snapshot).  The completed histories equal the
        uninterrupted run's.  Returns the recovered submission ids (rank 0's
        reading of the ledger; a rank other than 0 runs the generations in
        :meth:`drain` or :meth:`serve_forever` and returns [] here)."""
        if not self._owner:
            return []
        in_flight: Dict[Tuple[str, int], List[str]] = {}
        with self._lock:
            for sub_id, rec in self._ledger.items():
                if rec["state"] == "running":
                    key = (rec["fingerprint"], int(rec["gen"]))
                    in_flight.setdefault(key, []).append(sub_id)
        recovered: List[str] = []
        for (fp, gen), _ids in sorted(in_flight.items()):
            gen_dir = self._gen_dir(fp, gen)
            record_path = gen_dir / "generation.json"
            if not record_path.exists():
                for sub_id in _ids:
                    self._update(
                        sub_id, state="failed",
                        error="generation record lost before first write",
                    )
                continue
            with open(record_path, encoding="utf-8") as fh:
                record = json.load(fh)
            ids = [s["id"] for s in record["submissions"]]
            self._run_generation(fp, ids, gen=gen, resume=True,
                                 template_id=record.get("template"))
            recovered.extend(ids)
        return recovered

    # ------------------------------------------------------------------
    # Drive

    def drain(self) -> None:
        """Run generations until the queue is empty (tests, one-shot).  Over
        a group every rank calls it: rank 0 runs the queue (after any
        :meth:`recover`) and then stops the other ranks, which run what it
        announces until then."""
        if not self._owner:
            self._follow()
            return
        while True:
            nxt = self._next_generation()
            if nxt is None:
                break
            self._run_generation(*nxt)
        self._release()

    def serve_forever(self) -> None:
        """Bind the socket, recover the work that was running, then serve
        until a ``shutdown`` request (graceful: the current generation
        completes; every state transition is durable anyway).  Over a group
        rank 0 does this, ticking while idle, and stops the other ranks at
        the end; they run what it announces."""
        if not self._owner:
            self._follow()
            return
        self._start_listener()
        try:
            self.recover()
            while not self._stop.is_set():
                nxt = self._next_generation()
                if nxt is not None:
                    self._run_generation(*nxt)
                else:
                    self._stop.wait(self.poll_interval_s)
                    self._tick()
            self._release()
        finally:
            self.close()

    def _start_listener(self) -> None:
        from murmura_tpu_torch.serve.protocol import ServerSocket

        self._server = ServerSocket(self.socket_path)
        self._listener = threading.Thread(
            target=self._listen, name="murmura-serve-listener", daemon=True,
        )
        self._listener.start()

    def _listen(self) -> None:
        from murmura_tpu_torch.serve.protocol import serve_connection

        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept(timeout=0.2)
            except socket.timeout:
                continue
            except OSError:
                break
            serve_connection(conn, self.handle_request)

    def close(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._listener is not None:
            self._listener.join(timeout=2.0)
            self._listener = None

    # ------------------------------------------------------------------
    # Protocol handler

    def metrics_registry(self):
        """The daemon's scrape (``{"op": "metrics"}``): the lifetime
        counters, the ledger's census by state, the queue and bucket
        gauges, then each tenant's durable event stream folded per tenant.
        Everything is a replay of durable state."""
        from murmura_tpu_torch.telemetry.metrics import (
            MetricsRegistry,
            fold_run_events,
        )

        reg = MetricsRegistry()
        with self._lock:
            reg.set_gauge(
                "murmura_serve_uptime_seconds",
                time.time() - self.started_at,
                help="daemon uptime",
            )
            reg.set_gauge(
                "murmura_serve_queue_depth", len(self._pending),
                help="queued submissions awaiting a generation",
            )
            for cname, cval in self._counters.items():
                reg.inc(
                    "murmura_serve_lifetime", float(cval),
                    labels={"counter": cname},
                    help="cumulative daemon counters (admissions, "
                         "evictions, resumes, compiles, generations)",
                )
            states: Dict[str, int] = {}
            tenant_ids = []
            for sub_id, rec in self._ledger.items():
                states[rec["state"]] = states.get(rec["state"], 0) + 1
                tenant_ids.append(sub_id)
            for state, count in sorted(states.items()):
                reg.set_gauge(
                    "murmura_serve_submissions", count,
                    labels={"state": state},
                    help="ledger census by lifecycle state",
                )
            for fp, b in self._buckets.items():
                reg.set_gauge(
                    "murmura_serve_bucket_lanes", b["gang"].batch,
                    labels={"bucket": fp}, help="compiled lane capacity",
                )
                reg.set_gauge(
                    "murmura_serve_bucket_running", len(b["lanes"]),
                    labels={"bucket": fp}, help="occupied lanes",
                )
        for sub_id in tenant_ids:
            run_dir = self.state_dir / "telemetry" / sub_id
            if run_dir.exists():
                fold_run_events(reg, run_dir, labels={"tenant": sub_id})
        return reg

    def handle_request(self, request: Dict[str, Any]) -> Dict[str, Any]:
        from murmura_tpu_torch import __version__
        from murmura_tpu_torch.telemetry.schema import MANIFEST_SCHEMA_VERSION

        op = request.get("op")
        if op == "ping":
            with self._lock:
                return {
                    "ok": True,
                    "pid": os.getpid(),
                    "uptime_s": time.time() - self.started_at,
                    "version": __version__,
                    "schema_version": MANIFEST_SCHEMA_VERSION,
                    "counters": dict(self._counters),
                    "queued": len(self._pending),
                    "buckets": {
                        fp: {
                            "gen": b["gen"],
                            "batch": b["gang"].batch,
                            "running": len(b["lanes"]),
                        }
                        for fp, b in self._buckets.items()
                    },
                }
        if op == "metrics":
            from murmura_tpu_torch.telemetry.metrics import render_openmetrics

            return {
                "ok": True,
                "content_type": "application/openmetrics-text; "
                                "version=1.0.0; charset=utf-8",
                "text": render_openmetrics(self.metrics_registry()),
            }
        if op == "submit":
            rec = self.submit_config(request.get("config"))
            return {
                "ok": True, "id": rec["id"], "bucket": rec["fingerprint"],
            }
        if op == "status":
            with self._lock:
                rec = self._ledger.get(request.get("id"))
            if rec is None:
                return {"ok": False, "error": f"unknown id {request.get('id')}"}
            return {"ok": True, "submission": _jsonable(rec)}
        if op == "list":
            with self._lock:
                rows = [
                    {
                        "id": r["id"],
                        "state": r["state"],
                        "bucket": r["fingerprint"],
                        "gen": r.get("gen"),
                        "lane": r.get("lane"),
                        "rounds": r.get("rounds"),
                        "final_accuracy": r.get("final_accuracy"),
                    }
                    for _, r in sorted(self._ledger.items())
                ]
                counters = dict(self._counters)
            return {
                "ok": True,
                "uptime_s": time.time() - self.started_at,
                "counters": counters,
                "submissions": rows,
            }
        if op == "evict":
            rec = self.evict(
                request.get("id"), request.get("reason", "evicted"),
            )
            return {"ok": True, "submission": _jsonable(rec)}
        if op == "shutdown":
            self._stop.set()
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

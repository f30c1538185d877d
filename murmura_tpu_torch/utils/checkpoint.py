# Copy of durable_replace, save_checkpoint, restore_checkpoint and
# has_checkpoint from murmura_tpu/utils/checkpoint.py, with the port's own
# payload container.
"""Run-state checkpoints on disk, and the crash-safe file replacement they
(and the telemetry writer's manifest) commit through.

A checkpoint is a payload blob and one JSON commit record:

    <dir>/state.<round>.pt   torch.save bytes of {params, agg_state, rng, round}
    <dir>/extra.<round>.pt   orchestrator extra sections (optional)
    <dir>/meta.json          {format, version, round, history, round_times,
                              sections, extra_meta}

The payload is ``torch.save`` of a dict of CPU tensors, read back with
``torch.load(..., weights_only=True)``: it carries bfloat16 and int8 leaves
bit for bit (npz holds no bfloat16), and loading runs no pickled code.  The
JAX package writes flax msgpack (``state.<round>.msgpack``, version 3, no
``format``), which the port cannot read; such a directory is refused by
name before any payload is opened.

``meta.json`` is the single commit point: the generation-suffixed payload
files are written (fsync'd) first, the meta replace publishes them, and
only after that commit are older generations deleted.  A crash at any point
leaves either the previous complete snapshot or the new one, never a torn
pair; the round stored in each payload file is cross-checked against
``meta.json`` so a file spliced in from another snapshot is refused.
"""

import io
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

FORMAT = "murmura_tpu_torch"
CKPT_VERSION = 1
META_FILE = "meta.json"
_STATE_TMPL = "state.{round}.pt"
_EXTRA_TMPL = "extra.{round}.pt"
# The JAX package's payload names: a committed meta.json beside one of them
# is a JAX snapshot (refused, never half-read).
_JAX_STATE_TMPL = "state.{round}.msgpack"
_JAX_LEGACY_STATE = "state.msgpack"


def durable_replace(directory, name: str, data) -> None:
    """Write ``data`` (bytes or a buffer) to ``directory/name`` via a temp
    file so a crash at ANY point leaves either the old complete file or the
    new complete file: the temp file's data is fsync'd before the rename and
    the directory entry after it (os.replace alone does not survive a host
    crash)."""
    directory = Path(directory)
    tmp = directory / (name + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        # os.write may write short: loop until every byte is down.
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, directory / name)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _payload_paths(directory: Path, round_num: int) -> Tuple[Path, Path]:
    return (
        directory / _STATE_TMPL.format(round=int(round_num)),
        directory / _EXTRA_TMPL.format(round=int(round_num)),
    )


def _to_bytes(obj) -> memoryview:
    """``torch.save`` of ``obj``, as a view of the buffer (no copy)."""
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getbuffer()


def _host(t) -> torch.Tensor:
    """One device-to-host copy of a whole tensor."""
    return torch.as_tensor(t).detach().to("cpu", copy=True).contiguous()


def _gc_old_generations(directory: Path, keep_round: int) -> None:
    """Delete payload generations other than the just-committed one,
    strictly after the meta replace."""
    keep = {p.name for p in _payload_paths(directory, keep_round)}
    for p in list(directory.glob("state.*.pt")) + list(directory.glob("extra.*.pt")):
        if p.name not in keep:
            try:
                p.unlink()
            except FileNotFoundError:
                pass


def save_checkpoint(
    directory,
    *,
    params: torch.Tensor,
    agg_state: Dict[str, torch.Tensor],
    rng: Any,
    round_num: int,
    history: Dict[str, list],
    round_times: list,
    extra_arrays: Optional[Dict[str, torch.Tensor]] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> int:
    """Write a checkpoint; returns the bytes written (payload and meta).

    ``params`` is the node-stacked flat ``[N, P]`` tensor (a gang's ``[S,
    N, P]``), ``agg_state`` the whole carried state, ``rng`` the run's seed
    (a gang's list of member seeds; the port's generators are a pure
    function of (seed, round)); each tensor is copied to the host once.  ``extra_arrays`` land in ``extra.<round>.pt`` and their names in
    ``meta.json["sections"]``, ``extra_meta`` (json-able) in
    ``meta.json["extra_meta"]``.
    """
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    extra_arrays = dict(extra_arrays or {})
    blob = _to_bytes({
        "params": _host(params),
        "agg_state": {k: _host(v) for k, v in agg_state.items()},
        "rng": torch.tensor(rng, dtype=torch.int64),
        # Duplicated in meta.json; restore cross-checks the two.
        "round": torch.tensor(int(round_num), dtype=torch.int64),
    })
    meta = json.dumps({
        "format": FORMAT,
        "version": CKPT_VERSION,
        "round": int(round_num),
        "history": history,
        "round_times": [float(t) for t in round_times],
        "sections": sorted(extra_arrays),
        "extra_meta": extra_meta or {},
    }).encode("utf-8")
    state_path, extra_path = _payload_paths(d, round_num)
    written = len(blob) + len(meta)
    if extra_arrays:
        extra = _to_bytes({**{k: _host(v) for k, v in extra_arrays.items()},
                           "__round__": torch.tensor(int(round_num), dtype=torch.int64)})
        durable_replace(d, extra_path.name, extra)
        written += len(extra)
    durable_replace(d, state_path.name, blob)
    durable_replace(d, META_FILE, meta)
    _gc_old_generations(d, round_num)
    return written


def _read_meta(d: Path) -> Dict[str, Any]:
    meta = json.loads((d / META_FILE).read_text())
    if meta.get("format") != FORMAT:
        if meta.get("format") is None and "version" in meta:
            raise ValueError(
                f"{d} holds a snapshot written by the JAX package (murmura_tpu: "
                f"state.<round>.msgpack, checkpoint version {meta.get('version')}); the "
                f"PyTorch port reads only its own snapshots (format '{FORMAT}') — "
                "resume it with `python -m murmura_tpu run`, or point --checkpoint-dir "
                "at a clean directory"
            )
        raise ValueError(f"{d / META_FILE} is not a {FORMAT} snapshot "
                         f"(format {meta.get('format')!r})")
    if meta.get("version") != CKPT_VERSION:
        raise ValueError(
            f"Checkpoint version {meta.get('version')} != {CKPT_VERSION} ({FORMAT})")
    return meta


def _load(path: Path, device) -> Dict[str, Any]:
    return torch.load(io.BytesIO(path.read_bytes()), weights_only=True,
                      map_location=torch.device(device))


def restore_checkpoint(directory, device="cpu") -> Tuple[
    torch.Tensor, Dict[str, torch.Tensor], int, int, Dict[str, list], list,
    Dict[str, torch.Tensor], Dict[str, Any],
]:
    """Load (params, agg_state, rng, round, history, round_times,
    extra_arrays, extra_meta), the tensors onto ``device``; ``rng`` is the
    seed (an int) or a gang's list of seeds.  Validation
    against a live run is the caller's (durability/snapshot.py)."""
    d = Path(directory)
    meta = _read_meta(d)
    state_path, extra_path = _payload_paths(d, meta["round"])
    state = _load(state_path, device)
    if int(state["round"]) != int(meta["round"]):
        raise ValueError(
            f"Torn checkpoint: {state_path.name} is at round {int(state['round'])} "
            f"but meta.json says round {int(meta['round'])} — the file was spliced "
            "from another snapshot (the commit-point writer cannot produce this); "
            "restart from a clean checkpoint directory"
        )
    sections = list(meta.get("sections", []))
    extra_arrays: Dict[str, torch.Tensor] = {}
    if sections:
        extra_arrays = _load(extra_path, device)
        extra_round = extra_arrays.pop("__round__", None)
        if extra_round is None or int(extra_round) != int(meta["round"]):
            raise ValueError(
                f"Torn checkpoint: {extra_path.name} is at round "
                f"{None if extra_round is None else int(extra_round)} but meta.json "
                f"says round {int(meta['round'])} — the file was spliced from another "
                "snapshot; restart from a clean checkpoint directory"
            )
        missing = sorted(set(sections) - set(extra_arrays))
        if missing:
            raise ValueError(
                f"Incomplete snapshot: meta.json lists sections {missing} that the "
                "extra section file does not contain"
            )
    return (
        state["params"],
        dict(state["agg_state"]),
        state["rng"].tolist(),
        int(meta["round"]),
        meta["history"],
        list(meta["round_times"]),
        extra_arrays,
        dict(meta.get("extra_meta", {})),
    )


def committed_bytes(directory) -> int:
    """The bytes of the committed snapshot: meta.json and its payload files."""
    d = Path(directory)
    files = [d / META_FILE, *_payload_paths(d, _read_meta(d)["round"])]
    return sum(p.stat().st_size for p in files if p.exists())


def has_checkpoint(directory) -> bool:
    """A committed snapshot exists: a readable meta.json whose payload is
    present.  A JAX package snapshot counts too, so that a fresh run does
    not overwrite it and a resume refuses it by name instead of starting
    from round 0."""
    d = Path(directory)
    try:
        meta = json.loads((d / META_FILE).read_text())
    except (OSError, json.JSONDecodeError):
        return False
    r = int(meta.get("round", 0))
    return any((d / name).exists() for name in (
        _STATE_TMPL.format(round=r), _JAX_STATE_TMPL.format(round=r), _JAX_LEGACY_STATE))

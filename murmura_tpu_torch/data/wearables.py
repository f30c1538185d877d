# Copy of murmura_tpu/data/wearables.py: the port imports nothing from the JAX package.
"""Wearable sensor datasets: UCI HAR, PAMAP2, PPG-DaLiA
(reference: murmura/examples/wearables/datasets.py:12-531).

On-disk loaders are file-gated (zero-egress environment); every dataset has
a shape-identical synthetic fallback so the wearables configs stay runnable.
Partitioning follows the reference adapter (murmura/examples/wearables/
adapter.py:18-110): dirichlet / iid / natural (by subject id).
"""

from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from murmura_tpu_torch.data.base import (
    DEFAULT_HOLDOUT_FRACTION,
    FederatedArrays,
    split_holdout,
    stack_partitions,
)
from murmura_tpu_torch.data.partitioners import (
    dirichlet_partition,
    iid_partition,
    natural_partition,
)
from murmura_tpu_torch.data.synthetic import make_synthetic

# UCI HAR prefers its official on-disk test split over a carved holdout
# (reference adapter's split arg: murmura/examples/wearables/adapter.py:25);
# holdout_fraction: 0.0 disables held-out eval entirely.

# (input_dim, num_classes, num_subjects) — reference: wearables/datasets.py
# and models.py:195-300 (UCI HAR 561; PAMAP2 100-sample window x 40 features;
# PPG-DaLiA 32-sample window x 6 features).
WEARABLE_SPECS = {
    "uci_har": (561, 6, 30),
    "pamap2": (4000, 12, 9),
    "ppg_dalia": (192, 7, 15),
}

# Synthetic-fallback difficulty (separation in cluster-std units, label-noise
# fraction), calibrated so 50-round *held-out* FL accuracy of clean fedavg
# lands on the reference's published numbers (RESULTS_SUMMARY.md: UCI HAR
# 85.3, PAMAP2 90.2, PPG-DaLiA 66.5) instead of saturating at 1.0 —
# saturated data can't distinguish aggregation rules.  Recalibrated in
# round 3 after evaluation moved to held-out splits (measured fedavg
# finals: 0.85 / 0.90 / 0.67).
WEARABLE_DIFFICULTY = {
    "uci_har": (6.25, 0.06),
    "pamap2": (25.0, 0.02),
    "ppg_dalia": (6.0, 0.14),
}

# PAMAP2 protocol-file layout (reference: wearables/datasets.py:117-126):
# col 0 timestamp, 1 activity, 2 heart rate; IMUs (hand/chest/ankle) start at
# 3/20/37, 17 cols each; the first 13 per IMU (temp + accel16g + accel6g +
# gyro + mag) are valid features, the trailing 4 orientation cols are not.
PAMAP2_ACTIVITIES = [1, 2, 3, 4, 5, 6, 7, 12, 13, 16, 17, 24]
PAMAP2_IMU_STARTS = (3, 20, 37)
PAMAP2_HEART_RATE_COL = 2
PAMAP2_ACTIVITY_COL = 1

# PPG-DaLiA wrist-sensor rates (reference: wearables/datasets.py:333-340):
# ACC 32 Hz, BVP 64 Hz, EDA/TEMP 4 Hz; labels at 4 Hz.
PPG_ACTIVITIES = [1, 2, 3, 4, 5, 6, 7]


def _load_uci_har(root: Path, split: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """UCI HAR: 561 engineered features, 6 activities, 30 subjects
    (reference: wearables/datasets.py:12-89)."""
    d = root / split
    x = np.loadtxt(d / f"X_{split}.txt", dtype=np.float32)
    y = np.loadtxt(d / f"y_{split}.txt", dtype=np.int32) - 1  # 1-based -> 0-based
    subjects = np.loadtxt(d / f"subject_{split}.txt", dtype=np.int32)
    return x, y, subjects


def _nan_to_column_mean(features: np.ndarray) -> np.ndarray:
    """Replace NaNs with the column mean, or 0 where a column is all-NaN
    (reference: wearables/datasets.py:233-244)."""
    col_mean = np.nanmean(
        np.where(np.isnan(features).all(0), 0.0, features), axis=0
    )
    col_mean = np.nan_to_num(col_mean, nan=0.0)
    return np.where(np.isnan(features), col_mean[None, :], features)


def _majority_windows(
    features: np.ndarray,
    activities: np.ndarray,
    window: int,
    stride: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows with majority-activity labels, vectorized.

    The reference loops per window and takes the np.unique argmax (smallest
    activity id wins ties — wearables/datasets.py:246-275); a 2-D bincount
    over window rows reproduces that tie-break exactly.
    Returns (flattened windows [W, window*F], majority activity ids [W]).
    """
    num = len(features)
    if num < window:
        return (
            np.empty((0, window * features.shape[1]), np.float32),
            np.empty((0,), np.int64),
        )
    n_win = (num - window) // stride + 1
    idx = np.arange(n_win)[:, None] * stride + np.arange(window)[None, :]
    flat = features[idx].reshape(n_win, -1).astype(np.float32)

    acts = activities[idx]  # [W, window] of small non-negative ints
    n_ids = int(acts.max()) + 1
    counts = np.zeros((n_win, n_ids), np.int64)
    np.add.at(counts, (np.arange(n_win)[:, None], acts), 1)
    return flat, counts.argmax(axis=1)


def _zscore(x: np.ndarray) -> np.ndarray:
    """Per-column standardization with zero-std guard
    (reference: wearables/datasets.py:277-282)."""
    mean = x.mean(axis=0)
    std = x.std(axis=0)
    std[std == 0] = 1.0
    return (x - mean) / std


def _load_pamap2(
    root: Path, params: Dict[str, Any]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PAMAP2: per-subject protocol files -> activity-filtered rows ->
    NaN fill -> sliding windows with majority labels -> global z-score
    (reference: wearables/datasets.py:92-301)."""
    window = int(params.get("window_size", 100))
    stride = int(params.get("window_stride", 50))
    include_hr = bool(params.get("include_heart_rate", True))
    normalize = bool(params.get("normalize", True))
    activities = list(params.get("activities", PAMAP2_ACTIVITIES))
    subjects = list(params.get("subjects", range(101, 110)))
    act_to_idx = {a: i for i, a in enumerate(activities)}

    cols = ([PAMAP2_HEART_RATE_COL] if include_hr else []) + [
        c for start in PAMAP2_IMU_STARTS for c in range(start, start + 13)
    ]

    xs, ys, subs = [], [], []
    for sid in subjects:
        f = root / "Protocol" / f"subject{sid}.dat"
        if not f.exists():
            continue
        raw = np.loadtxt(f)
        act = raw[:, PAMAP2_ACTIVITY_COL].astype(np.int64)
        keep = np.isin(act, activities)
        feats = _nan_to_column_mean(raw[keep][:, cols])
        win, maj = _majority_windows(feats, act[keep], window, stride)
        if len(win):
            xs.append(win)
            ys.append(np.array([act_to_idx[a] for a in maj], np.int32))
            subs.append(np.full(len(win), sid, np.int32))

    if not xs:
        raise ValueError(f"No PAMAP2 data under {root}")
    x = np.vstack(xs)
    if normalize:
        x = _zscore(x)
    return x.astype(np.float32), np.concatenate(ys), np.concatenate(subs)


def _load_ppg_dalia(
    root: Path, params: Dict[str, Any]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PPG-DaLiA: per-subject pickles -> wrist signals downsampled to the
    4 Hz label rate -> [EDA, TEMP, ACC xyz, BVP] stack -> activity filter ->
    windows -> global z-score (reference: wearables/datasets.py:304-531)."""
    import pickle

    window = int(params.get("window_size", 32))
    stride = int(params.get("window_stride", 16))
    normalize = bool(params.get("normalize", True))
    activities = list(params.get("activities", PPG_ACTIVITIES))
    subjects = list(params.get("subjects", range(1, 16)))
    act_to_idx = {a: i for i, a in enumerate(activities)}

    xs, ys, subs = [], [], []
    for sid in subjects:
        f = root / f"S{sid}" / f"S{sid}.pkl"
        if not f.exists():
            continue
        with open(f, "rb") as fh:
            blob = pickle.load(fh, encoding="latin1")
        wrist = blob["signal"]["wrist"]
        eda = np.asarray(wrist["EDA"]).reshape(-1)  # native 4 Hz
        temp = np.asarray(wrist["TEMP"]).reshape(-1)  # native 4 Hz
        acc = np.asarray(wrist["ACC"])[::8, :]  # 32 Hz -> 4 Hz
        bvp = np.asarray(wrist["BVP"]).reshape(-1)[::16]  # 64 Hz -> 4 Hz
        act = np.asarray(blob["activity"]).reshape(-1).astype(np.int64)

        m = min(len(eda), len(temp), len(acc), len(bvp), len(act))
        feats = np.column_stack([eda[:m], temp[:m], acc[:m], bvp[:m]])
        feats = np.nan_to_num(feats, nan=0.0).astype(np.float32)
        keep = np.isin(act[:m], activities)
        win, maj = _majority_windows(feats[keep], act[:m][keep], window, stride)
        if len(win):
            xs.append(win)
            ys.append(np.array([act_to_idx[a] for a in maj], np.int32))
            subs.append(np.full(len(win), sid, np.int32))

    if not xs:
        raise ValueError(f"No PPG-DaLiA data under {root}")
    x = np.vstack(xs)
    if normalize:
        x = _zscore(x)
    return x.astype(np.float32), np.concatenate(ys), np.concatenate(subs)


def load_wearable_federated(
    dataset: str,
    params: Dict[str, Any],
    num_nodes: int,
    seed: int = 42,
    max_samples: Optional[int] = None,
) -> FederatedArrays:
    if dataset not in WEARABLE_SPECS:
        raise ValueError(f"Unknown wearable dataset: {dataset}")
    input_dim, num_classes, num_subjects = WEARABLE_SPECS[dataset]
    params = dict(params or {})
    data_path = params.get("data_path")
    split = params.get("split", "train")

    # The synthetic fallback mirrors the on-disk feature dimensionality,
    # including non-default window params (window_size x features/step).
    if dataset == "pamap2":
        feats = (1 if params.get("include_heart_rate", True) else 0) + 39
        input_dim = int(params.get("window_size", 100)) * feats
    elif dataset == "ppg_dalia":
        input_dim = int(params.get("window_size", 32)) * 6

    holdout = float(params.get("holdout_fraction", DEFAULT_HOLDOUT_FRACTION))
    x = y = subjects = None
    x_heldout = y_heldout = subjects_heldout = None
    if data_path and Path(data_path).exists():
        if dataset == "uci_har":
            x, y, subjects = _load_uci_har(Path(data_path), split)
            if split == "train" and holdout > 0.0:
                # Official held-out split (the reference adapter only ever
                # loads one split and evaluates on it); partitioned onto
                # nodes below with the same method as train.  UCI HAR test
                # subjects are disjoint from train subjects, so under
                # natural partitioning a node's test shard comes from
                # different people — the harder, standard HAR protocol.
                try:
                    x_heldout, y_heldout, subjects_heldout = _load_uci_har(
                        Path(data_path), "test"
                    )
                except OSError:
                    pass
        elif dataset == "pamap2":
            x, y, subjects = _load_pamap2(Path(data_path), params)
        elif dataset == "ppg_dalia":
            x, y, subjects = _load_ppg_dalia(Path(data_path), params)

    if x is None:
        n_total = int(params.get("num_samples", max(2000, 300 * num_nodes)))
        default_sep, default_noise = WEARABLE_DIFFICULTY[dataset]
        x, y = make_synthetic(
            num_samples=n_total,
            input_shape=(input_dim,),
            num_classes=num_classes,
            cluster_std=float(params.get("cluster_std", 1.5)),
            seed=seed,
            separation=float(params.get("separation", default_sep)),
            label_noise=float(params.get("label_noise", default_noise)),
        )
        rng = np.random.default_rng(seed)
        subjects = rng.integers(0, num_subjects, size=n_total)

    method = params.get("partition_method", "dirichlet")

    def _make_parts(yy, subs):
        if method == "dirichlet":
            return dirichlet_partition(
                yy, num_nodes, alpha=float(params.get("alpha", 0.5)), seed=seed
            )
        if method == "iid":
            return iid_partition(len(yy), num_nodes, seed=seed)
        if method == "natural":
            nat, _actual = natural_partition(subs)
            # Fold natural subject groups round-robin onto the requested nodes.
            parts = [[] for _ in range(num_nodes)]
            for g, p in enumerate(nat):
                parts[g % num_nodes].extend(p)
            return parts
        raise ValueError(f"Unknown partition_method: {method}")

    parts = _make_parts(y, subjects)
    if x_heldout is not None:
        # Official test split, partitioned onto nodes by the same method.
        test_parts = _make_parts(y_heldout, subjects_heldout)
        return stack_partitions(
            x, y, parts, max_samples=max_samples, num_classes=num_classes,
            test_partitions=test_parts, x_test=x_heldout, y_test=y_heldout,
        )
    test_parts = None
    if holdout > 0.0:
        parts, test_parts = split_holdout(parts, holdout, seed)
    return stack_partitions(
        x, y, parts, max_samples=max_samples, num_classes=num_classes,
        test_partitions=test_parts,
    )

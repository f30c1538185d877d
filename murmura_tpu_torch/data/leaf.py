# Copy of murmura_tpu/data/leaf.py.
"""LEAF benchmark datasets (femnist, celeba, shakespeare) from the LEAF JSON
layout (reference: murmura/examples/leaf/datasets.py:23-199, 300-377).

Loads per-split JSON shards with user->samples maps, applies the reference's
natural user partitioning (seeded user shuffle, round-robin users -> nodes,
paired train/test partitions — datasets.py:300-377).  When no ``data_path``
is given (or ``synthetic: true``), emits shape-identical synthetic data so
every config remains runnable in a zero-egress environment.
"""

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from murmura_tpu_torch.data.base import (
    DEFAULT_HOLDOUT_FRACTION,
    FederatedArrays,
    split_holdout,
    stack_partitions,
)
from murmura_tpu_torch.data.partitioners import dirichlet_partition, iid_partition
from murmura_tpu_torch.data.synthetic import make_synthetic, make_synthetic_sequences

FEMNIST_CLASSES = 62

# LEAF's fixed 80-char alphabet (reference: leaf/models/utils/
# language_utils.py:11); chars outside it map to index 80, hence vocab 81
# (LEAF itself folds unknowns onto the last position via str.find -> -1).
SHAKESPEARE_ALPHABET = (
    "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ[]"
    "abcdefghijklmnopqrstuvwxyz}"
)
SHAKESPEARE_VOCAB = len(SHAKESPEARE_ALPHABET) + 1  # 81


def _load_leaf_json_dir(split_dir: Path) -> Tuple[List[str], Dict[str, Dict]]:
    """Merge all JSON shards in a LEAF split dir into (users, user_data)
    (reference: datasets.py:23-93)."""
    users: List[str] = []
    user_data: Dict[str, Dict] = {}
    for shard in sorted(split_dir.glob("*.json")):
        with open(shard) as f:
            blob = json.load(f)
        users.extend(blob.get("users", []))
        user_data.update(blob.get("user_data", {}))
    return users, user_data


def _round_robin_users(
    users: List[str], num_nodes: int, seed: int
) -> List[List[str]]:
    """Seeded user shuffle then round-robin users -> nodes
    (reference: datasets.py:300-340)."""
    rng = np.random.default_rng(seed)
    order = list(users)
    rng.shuffle(order)
    groups: List[List[str]] = [[] for _ in range(num_nodes)]
    for i, u in enumerate(order):
        groups[i % num_nodes].append(u)
    return groups


def _decode_users(users: List[str], load_user):
    """Decode users via ``load_user(u) -> (ux, uy)`` into pooled arrays plus
    per-user (start, end) offsets."""
    xs, ys = [], []
    offsets: Dict[str, Tuple[int, int]] = {}
    cursor = 0
    for u in users:
        ux, uy = load_user(u)
        xs.append(ux)
        ys.append(uy)
        offsets[u] = (cursor, cursor + len(uy))
        cursor += len(uy)
    return np.concatenate(xs), np.concatenate(ys), offsets


def _stack_user_groups(
    users: List[str],
    groups: List[List[str]],
    load_user,
    num_classes: int,
    max_samples: Optional[int],
    test_users: Optional[List[str]] = None,
    load_user_test=None,
    holdout_fraction: float = DEFAULT_HOLDOUT_FRACTION,
    seed: int = 0,
) -> FederatedArrays:
    """Shared scaffolding for all LEAF loaders: decode each user's samples,
    then map the round-robin user groups onto node partitions.

    Held-out evaluation mirrors the reference's *paired* per-user train/test
    partitions (murmura/examples/leaf/datasets.py:300-377): when the LEAF
    ``test/`` split is available, each node's test shard holds exactly its
    own users' test samples; without one, ``holdout_fraction`` of each
    node's train shard is carved off instead.  ``holdout_fraction: 0``
    restores the reference's evaluate-on-train behavior for both cases.
    """
    x, y, offsets = _decode_users(users, load_user)
    partitions = [
        [i for u in group for i in range(*offsets[u])] for group in groups
    ]

    have = []
    if load_user_test is not None and test_users and holdout_fraction > 0.0:
        in_test = set(test_users)
        have = [u for u in users if u in in_test]
    if have:
        x_t, y_t, offsets_t = _decode_users(have, load_user_test)
        test_partitions = [
            [i for u in group if u in offsets_t for i in range(*offsets_t[u])]
            for group in groups
        ]
        # A node whose users all lack test/ samples evaluates on its train
        # shard (reference behavior) instead of on an empty mask, which
        # would score the node 0.0 and drag mean_accuracy.
        extra_x, extra_y = [], []
        cursor = len(y_t)
        for i, tp in enumerate(test_partitions):
            if not tp and partitions[i]:
                tr = partitions[i]
                test_partitions[i] = list(range(cursor, cursor + len(tr)))
                extra_x.append(x[tr])
                extra_y.append(y[tr])
                cursor += len(tr)
        if extra_x:
            x_t = np.concatenate([x_t] + extra_x)
            y_t = np.concatenate([y_t] + extra_y)
        return stack_partitions(
            x, y, partitions, max_samples=max_samples, num_classes=num_classes,
            test_partitions=test_partitions, x_test=x_t, y_test=y_t,
        )

    test_partitions = None
    if holdout_fraction > 0.0:
        partitions, test_partitions = split_holdout(
            partitions, holdout_fraction, seed
        )
    return stack_partitions(
        x, y, partitions, max_samples=max_samples, num_classes=num_classes,
        test_partitions=test_partitions,
    )


def _load_test_split(data_path: Path):
    """(users, user_data) of the LEAF ``test/`` split, or ([], {}) when the
    dataset ships without one."""
    test_dir = data_path / "test"
    if test_dir.exists():
        return _load_leaf_json_dir(test_dir)
    return [], {}


def _femnist_from_json(
    data_path: Path, num_nodes: int, seed: int, max_samples: Optional[int],
    holdout_fraction: float,
) -> FederatedArrays:
    train_users, train_data = _load_leaf_json_dir(data_path / "train")
    test_users, test_data = _load_test_split(data_path)
    groups = _round_robin_users(train_users, num_nodes, seed)

    def decode(user_data):
        def load_user(u):
            ux = np.asarray(user_data[u]["x"], dtype=np.float32).reshape(-1, 28, 28, 1)
            uy = np.asarray(user_data[u]["y"], dtype=np.int32)
            return ux, uy

        return load_user

    return _stack_user_groups(
        train_users, groups, decode(train_data), FEMNIST_CLASSES, max_samples,
        test_users=test_users,
        load_user_test=decode(test_data) if test_users else None,
        holdout_fraction=holdout_fraction, seed=seed,
    )


def _celeba_from_json(
    data_path: Path,
    num_nodes: int,
    seed: int,
    max_samples: Optional[int],
    params: Dict[str, Any],
) -> FederatedArrays:
    """CelebA: JSON shards hold per-celebrity image filenames + binary
    labels; pixels come from raw/img_align_celeba, resized to
    image_size x image_size RGB in [0, 1], NHWC as the models take it
    (reference semantics: examples/leaf/datasets.py:96-199, which emits CHW
    for torch)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "CelebA image decoding needs Pillow: pip install 'murmura-tpu[data]'"
        ) from e

    image_size = int(params.get("image_size", 84))
    users, user_data = _load_leaf_json_dir(data_path / "train")
    test_users, test_data = _load_test_split(data_path)
    groups = _round_robin_users(users, num_nodes, seed)
    images_dir = Path(params.get("image_dir", data_path / "raw" / "img_align_celeba"))

    def decode(blob):
        def load_user(u):
            fnames = blob[u]["x"]
            uy = np.asarray(blob[u]["y"], dtype=np.int32)
            if max_samples is not None:
                # Per-node truncation happens in stack_partitions; capping
                # each user here too keeps full-dataset decode memory bounded
                # (~85 KB/image x 200k images otherwise).
                fnames = fnames[:max_samples]
                uy = uy[:max_samples]
            ux = np.empty((len(fnames), image_size, image_size, 3), np.float32)
            for i, name in enumerate(fnames):
                p = images_dir / name
                if not p.exists():
                    p = images_dir.parent / name  # raw/<name> fallback
                img = Image.open(p).resize((image_size, image_size)).convert("RGB")
                ux[i] = np.asarray(img, dtype=np.float32) / 255.0
            return ux, uy

        return load_user

    return _stack_user_groups(
        users, groups, decode(user_data), 2, max_samples,
        test_users=test_users,
        load_user_test=decode(test_data) if test_users else None,
        holdout_fraction=float(
            params.get("holdout_fraction", DEFAULT_HOLDOUT_FRACTION)
        ),
        seed=seed,
    )


def _shakespeare_from_json(
    data_path: Path, num_nodes: int, seed: int, max_samples: Optional[int],
    holdout_fraction: float,
) -> FederatedArrays:
    """Shakespeare next-char prediction: JSON x = 80-char contexts,
    y = next char, one user per role; chars indexed by the fixed LEAF
    alphabet with unknowns -> index 80 (reference layout:
    leaf/data/shakespeare; vocab: leaf/models/utils/language_utils.py:11)."""
    lut = np.full(256, len(SHAKESPEARE_ALPHABET), dtype=np.int32)
    for i, ch in enumerate(SHAKESPEARE_ALPHABET):
        lut[ord(ch)] = i

    def encode(s: str) -> np.ndarray:
        # Vectorized codepoint extraction; anything outside Latin-1 folds to
        # codepoint 0 (NUL, not in the alphabet) so it lands in the unknown
        # bucket 80 — a latin1 errors="replace" encode would instead emit
        # '?', which IS in the alphabet, silently mislabeling those chars.
        cp = np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)
        return lut[np.where(cp < 256, cp, 0).astype(np.uint8)]

    users, user_data = _load_leaf_json_dir(data_path / "train")
    test_users, test_data = _load_test_split(data_path)
    groups = _round_robin_users(users, num_nodes, seed)

    def decode(blob):
        def load_user(u):
            ux = encode("".join(blob[u]["x"])).reshape(len(blob[u]["x"]), -1)
            uy = encode(
                "".join(c[0] if c else "\0" for c in blob[u]["y"])
            ).astype(np.int32)
            return ux, uy

        return load_user

    return _stack_user_groups(
        users, groups, decode(user_data), SHAKESPEARE_VOCAB, max_samples,
        test_users=test_users,
        load_user_test=decode(test_data) if test_users else None,
        holdout_fraction=holdout_fraction, seed=seed,
    )


def load_leaf_federated(
    dataset: str,
    params: Dict[str, Any],
    num_nodes: int,
    seed: int = 42,
    max_samples: Optional[int] = None,
) -> FederatedArrays:
    """Load a LEAF dataset (reference: murmura/examples/leaf/adapter.py:19-61)."""
    params = dict(params or {})
    data_path = params.get("data_path")
    use_synthetic = bool(params.get("synthetic", data_path is None))
    holdout = float(params.get("holdout_fraction", DEFAULT_HOLDOUT_FRACTION))

    if not use_synthetic:
        root = Path(data_path)
        if not root.exists():
            raise FileNotFoundError(
                f"LEAF data path not found: {root}. Pass data.params.synthetic: true "
                "for shape-identical synthetic data."
            )
        if dataset == "femnist":
            return _femnist_from_json(root, num_nodes, seed, max_samples, holdout)
        if dataset == "celeba":
            return _celeba_from_json(root, num_nodes, seed, max_samples, params)
        if dataset == "shakespeare":
            return _shakespeare_from_json(root, num_nodes, seed, max_samples, holdout)
        raise ValueError(f"Unknown LEAF dataset: {dataset}")

    # ---- synthetic, shape-identical fallbacks ----------------------------
    n_total = int(params.get("num_samples", max(2000, 200 * num_nodes)))
    if dataset == "femnist":
        x, y = make_synthetic(
            num_samples=n_total,
            input_shape=(28, 28, 1),
            num_classes=FEMNIST_CLASSES,
            cluster_std=float(params.get("cluster_std", 2.0)),
            seed=seed,
        )
        num_classes = FEMNIST_CLASSES
    elif dataset == "celeba":
        x, y = make_synthetic(
            num_samples=n_total,
            input_shape=(84, 84, 3),
            num_classes=2,
            seed=seed,
        )
        num_classes = 2
    elif dataset == "shakespeare":
        x, y = make_synthetic_sequences(
            num_samples=n_total,
            seq_len=int(params.get("seq_len", 80)),
            vocab_size=SHAKESPEARE_VOCAB,
            seed=seed,
        )
        num_classes = SHAKESPEARE_VOCAB
    else:
        raise ValueError(f"Unknown LEAF dataset: {dataset}")

    if params.get("partition_method", "dirichlet") == "dirichlet" and num_classes > 2:
        parts = dirichlet_partition(
            y, num_nodes, alpha=float(params.get("alpha", 0.5)), seed=seed
        )
    else:
        parts = iid_partition(len(y), num_nodes, seed=seed)
    test_parts = None
    if holdout > 0.0:
        parts, test_parts = split_holdout(parts, holdout, seed)
    return stack_partitions(
        x, y, parts, max_samples=max_samples, num_classes=num_classes,
        test_partitions=test_parts,
    )

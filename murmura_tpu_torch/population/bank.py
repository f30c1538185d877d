# Copy of murmura_tpu/population/bank.py.
"""Host-side per-user state bank: the persistent half of cohort streaming.

One flat float row per virtual user holds that user's model parameters
between activations.  The bank is the *host* side of the streaming design
(docs/SCALING.md): the device only ever holds the active cohort's
``[N, P]`` rows; everything else lives here, memory-mapped so a
1M-user x P-param population costs disk pages only for users that have
actually been activated (the file is created sparse and rows are touched
lazily), never resident RAM.

Initialization is lazy: a user that has never been activated has no row
yet — ``gather`` fills their slot from the caller's default rows (the
round program's seed-derived slot init), and the row becomes persistent on
the first ``scatter`` (write-back after training).  Two users first
activated in the same cohort slot therefore start from the same slot init;
their rows diverge from the first round on and persist individually — the
Teleportation-style virtual-population semantics (arXiv:2501.15259).
"""

import os
import tempfile
from typing import Optional

import numpy as np

# Populations whose full bank fits comfortably in RAM skip the memmap
# (and its TemporaryDirectory) entirely.
_IN_MEMORY_BYTES = 256 * 1024 * 1024


class PopulationBank:
    """[virtual_size, row_dim] lazily-initialized per-user row store.

    Args:
        virtual_size: number of virtual users U.
        row_dim: flat parameter dimension P per user.
        dtype: row dtype (the resident param dtype of the round program).
        directory: where the memory-mapped backing file lives; ``None``
            uses RAM for small banks and a TemporaryDirectory (cleaned up
            with the bank) for large ones.
    """

    def __init__(
        self,
        virtual_size: int,
        row_dim: int,
        dtype=np.float32,
        directory: Optional[str] = None,
    ):
        if virtual_size < 1:
            raise ValueError(f"virtual_size must be >= 1, got {virtual_size}")
        if row_dim < 1:
            raise ValueError(f"row_dim must be >= 1, got {row_dim}")
        self.virtual_size = int(virtual_size)
        self.row_dim = int(row_dim)
        self.dtype = np.dtype(dtype)
        nbytes = self.virtual_size * self.row_dim * self.dtype.itemsize
        self._tmpdir = None
        # Whether an existing backing file was adopted instead of created
        # — the durability resume path requires this for external banks.
        self.reattached = False
        if directory is None and nbytes <= _IN_MEMORY_BYTES:
            self.path = None
            self._rows = np.zeros(
                (self.virtual_size, self.row_dim), self.dtype
            )
        else:
            if directory is None:
                self._tmpdir = tempfile.TemporaryDirectory(
                    prefix="murmura_population_"
                )
                directory = self._tmpdir.name
            os.makedirs(directory, exist_ok=True)
            self.path = os.path.join(directory, "bank.dat")
            # A pre-existing file of the right size is REATTACHED ("r+")
            # instead of truncated — the durability resume path
            # (durability/snapshot.py) re-opens a flushed bank in place.
            # Stale rows in a reused directory are harmless: nothing reads
            # a row until its user is marked in ``_has_row``, which starts
            # all-False and is restored separately on resume.
            nominal = self.virtual_size * self.row_dim * self.dtype.itemsize
            existing = (
                os.path.getsize(self.path)
                if os.path.exists(self.path) else None
            )
            if existing is not None and existing != nominal:
                # mode="w+" would ftruncate a file that may be the flushed
                # row data of a live snapshot (durability/snapshot.py
                # "external" mode) — a config whose virtual_size/model
                # changed must refuse BEFORE destroying it, not after a
                # restore-time validation that would come too late.
                raise ValueError(
                    f"population bank {self.path} holds {existing} bytes "
                    f"but this config needs {nominal} "
                    f"({self.virtual_size} users x {self.row_dim} f32) — "
                    "refusing to truncate an existing bank; point "
                    "population.bank_dir at a clean directory or restore "
                    "the matching config"
                )
            reattach = existing is not None
            self.reattached = reattach
            # mode="w+" ftruncates to the nominal size; the file is sparse,
            # so disk/page-cache cost follows *touched* rows, not U x P.
            self._rows = np.memmap(
                self.path, dtype=self.dtype, mode="r+" if reattach else "w+",
                shape=(self.virtual_size, self.row_dim),
            )
        # Which users have a persistent row (first write-back sets it).
        self._has_row = np.zeros(self.virtual_size, dtype=bool)

    @property
    def activated(self) -> int:
        """Users with a persistent row (ever written back)."""
        return int(self._has_row.sum())

    def gather(self, users: np.ndarray, default_rows: np.ndarray) -> np.ndarray:
        """[C, P] rows for ``users``; slot ``j`` of a never-activated user
        falls back to ``default_rows[j]`` (the slot's seed init)."""
        users = np.asarray(users, dtype=np.int64)
        if users.min(initial=0) < 0 or users.max(initial=0) >= self.virtual_size:
            raise IndexError(
                f"user ids out of range [0, {self.virtual_size})"
            )
        out = np.array(default_rows, dtype=self.dtype, copy=True)
        known = self._has_row[users]
        if known.any():
            out[known] = self._rows[users[known]]
        return out

    def scatter(self, users: np.ndarray, rows: np.ndarray) -> None:
        """Write back ``rows`` for ``users``; marks them persistent."""
        users = np.asarray(users, dtype=np.int64)
        self._rows[users] = np.asarray(rows, dtype=self.dtype)
        self._has_row[users] = True

    def has_rows(self, users: np.ndarray) -> np.ndarray:
        """[C] bool: which of ``users`` have a persistent row."""
        return self._has_row[np.asarray(users, dtype=np.int64)].copy()

    def rows_of(self, users: np.ndarray) -> np.ndarray:
        """Raw rows (no default fallback) — test/inspection helper."""
        return np.array(self._rows[np.asarray(users, dtype=np.int64)])

    @property
    def activated_users(self) -> np.ndarray:
        """[activated] int64 ids of users with a persistent row."""
        return np.flatnonzero(self._has_row).astype(np.int64)

    def flush(self) -> None:
        """Push dirty pages to the backing file (memmap-backed banks;
        no-op in RAM) — the cheap half of a snapshot: the rows stay in
        place, only the activation mask rides the snapshot payload."""
        if self.path is not None:
            self._rows.flush()

    def restore_activation(self, has_row: np.ndarray) -> None:
        """Adopt a restored activation mask (durability resume)."""
        has_row = np.asarray(has_row, dtype=bool)
        if has_row.shape != (self.virtual_size,):
            raise ValueError(
                f"activation mask shape {has_row.shape} != "
                f"({self.virtual_size},)"
            )
        self._has_row = has_row.copy()

    def close(self) -> None:
        if self._tmpdir is not None:
            # Drop the memmap before the directory vanishes.
            self._rows = None
            self._tmpdir.cleanup()
            self._tmpdir = None

"""Serving (the PyTorch counterpart of murmura_tpu/serve/): the grid
scheduler (``grid``) and the crash-surviving multi-tenant daemon
(``serve`` / ``submit``).

Both stand on one invariant: a config's structural fingerprint decides
which warm gang can run it, and everything else (seed, lr, attack
strength) is a value spliced into a lane.
"""

from murmura_tpu_torch.serve.daemon import (
    ServeDaemon,
    SubmissionError,
    normalize_submission,
)
from murmura_tpu_torch.serve.protocol import ServerSocket, send_request
from murmura_tpu_torch.serve.scheduler import (
    GridBucket,
    GridCell,
    cell_program,
    expand_cells,
    load_grid,
    plan_grid,
    run_grid,
    structural_fingerprint,
    write_grid,
)

__all__ = [
    "GridBucket",
    "GridCell",
    "cell_program",
    "expand_cells",
    "load_grid",
    "plan_grid",
    "run_grid",
    "structural_fingerprint",
    "write_grid",
    "ServeDaemon",
    "SubmissionError",
    "normalize_submission",
    "ServerSocket",
    "send_request",
]

"""Socket addresses of the ZMQ backend (copy of
murmura_tpu/distributed/endpoints.py).

IPC (single machine): per-run directories under ipc_dir so concurrent runs
never collide.  TCP (multi-machine): node i binds base_port + i; per-node
host overrides via node_hosts.
"""

import os
from typing import Optional

from murmura_tpu_torch.config.schema import DistributedConfig


class Endpoints:
    """Resolves bind/connect addresses for nodes and the monitor."""

    MONITOR_ID = -1

    def __init__(self, cfg: DistributedConfig, run_id: str):
        self.cfg = cfg
        self.run_id = run_id

    # -- IPC ----------------------------------------------------------------

    def _ipc_path(self, name: str) -> str:
        return os.path.join(self.cfg.ipc_dir, self.run_id, name)

    def ensure_dirs(self) -> None:
        if self.cfg.transport == "ipc":
            os.makedirs(os.path.join(self.cfg.ipc_dir, self.run_id), exist_ok=True)

    def node_checkpoint_path(self, node_id: int) -> str:
        """Per-node crash-recovery checkpoint (faults.enabled runs).

        Lives under the run's ipc_dir regardless of transport: it is a
        local path on whichever machine hosts the node, which is the
        durability a restarted process on the same machine needs.
        """
        return self._ipc_path(f"node_{node_id}.ckpt.npz")

    # -- addresses ----------------------------------------------------------

    def node_bind(self, node_id: int, host: Optional[str] = None) -> str:
        """Address node_id's PULL socket binds on."""
        if self.cfg.transport == "ipc":
            return f"ipc://{self._ipc_path(f'node_{node_id}')}"
        bind_host = host or "0.0.0.0"
        return f"tcp://{bind_host}:{self.cfg.base_port + node_id}"

    def node_connect(self, node_id: int) -> str:
        """Address peers use to PUSH to node_id."""
        if self.cfg.transport == "ipc":
            return f"ipc://{self._ipc_path(f'node_{node_id}')}"
        host = (self.cfg.node_hosts or {}).get(node_id, self.cfg.host)
        return f"tcp://{host}:{self.cfg.base_port + node_id}"

    def monitor_bind(self) -> str:
        if self.cfg.transport == "ipc":
            return f"ipc://{self._ipc_path('monitor')}"
        return f"tcp://0.0.0.0:{self.cfg.coordinator_pull_port}"

    def monitor_connect(self) -> str:
        if self.cfg.transport == "ipc":
            return f"ipc://{self._ipc_path('monitor')}"
        return f"tcp://{self.cfg.host}:{self.cfg.coordinator_pull_port}"

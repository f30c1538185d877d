"""ZeroMQ multi-process backend (the PyTorch counterpart of
murmura_tpu/distributed/; reference: murmura/distributed/).

One OS process per FL node plus a passive monitor; round boundaries are
wall-clock (t_start + k * round_duration_s) with no control messages;
fault tolerance is deadline-based partial aggregation (reference:
murmura/distributed/node_process.py:8-12, 249-276).  Each node runs its
model and its rule on the CUDA card (``cuda:(node_id % device_count)``)
unless the caller asks for the CPU.  ``zmq`` is imported where a socket is
made, so the package imports without pyzmq.
"""

from murmura_tpu_torch.distributed.endpoints import Endpoints
from murmura_tpu_torch.distributed.messaging import MsgType, decode, encode

__all__ = ["Endpoints", "MsgType", "encode", "decode"]

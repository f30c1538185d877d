"""Wire format of the ZMQ backend (copy of
murmura_tpu/distributed/messaging.py; the frames are the JAX package's byte
for byte, so a node of either package can talk to the other's).

2-frame multipart: header = struct("!Bii") (1-byte MsgType + 4-byte sender
id + 4-byte round tag), then the payload.  The round tag lets receivers drop
stale messages that arrive after their round's deadline.  Model states
travel as flattened float32 parameter vectors serialized with numpy;
metrics and claims use pickle.
"""

import io
import pickle
import struct
from enum import IntEnum
from typing import Any, Tuple

import numpy as np

_HEADER = struct.Struct("!Bii")


class MsgType(IntEnum):
    MODEL_STATE = 1
    METRICS = 2
    TOPO_CLAIM = 3
    # Intra-coalition benign-state exchange for the colluding attacks
    # (ALIE, IPM: attackers coordinate out-of-band by construction).
    COLLUDE_STATE = 4


def pack_state(flat: np.ndarray) -> bytes:
    """Serialize a flat float32 parameter vector."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(flat, dtype=np.float32), allow_pickle=False)
    return buf.getvalue()


def unpack_state(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


def pack_obj(obj: Any) -> bytes:
    """Serialize metrics / topology claims."""
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def unpack_obj(payload: bytes) -> Any:
    return pickle.loads(payload)


def encode(
    msg_type: MsgType, sender: int, payload: bytes, round_idx: int
) -> Tuple[bytes, bytes]:
    """Build the 2-frame multipart message."""
    return _HEADER.pack(int(msg_type), sender, round_idx), payload


def decode(frames) -> Tuple[MsgType, int, int, bytes]:
    """Parse a received multipart message -> (type, sender, round, payload)."""
    if len(frames) != 2:
        raise ValueError(f"Expected 2 frames, got {len(frames)}")
    msg_type, sender, round_idx = _HEADER.unpack(frames[0])
    return MsgType(msg_type), sender, round_idx, frames[1]

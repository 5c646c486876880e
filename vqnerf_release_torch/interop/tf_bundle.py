"""A numpy reader of TensorFlow 2 checkpoints (TensorBundle V2), in place of
``tf.train.load_checkpoint`` and ``tf.train.latest_checkpoint`` where there
is no TensorFlow.

A checkpoint prefix P is the file P.index and the shards
P.data-NNNNN-of-MMMMM. The index is a LevelDB-format table:

  * a 48-byte footer: the block handles (varint64 offset, varint64 size)
    of the meta-index and the index block, zero padding to 40 bytes, and
    the magic 0xdb4775248b80fb57 (little-endian);
  * each block followed by a 5-byte trailer, its compression type (0 =
    none, 1 = Snappy) and the masked CRC-32C of the block and type byte;
  * a block's entries: varint32 shared and unshared key lengths and value
    length, the unshared key bytes (the key prefix-compressed against the
    previous key of its restart run) and the value; then the uint32
    restart offsets and their count;
  * the index block maps a key at or past each data block's last key to
    the data block's handle.

In the data blocks the key "" holds a BundleHeaderProto (num_shards,
endianness) and every other key a BundleEntryProto (dtype, shape,
shard_id, offset, size, crc32c, slices), whose bytes in the shard carry
the masked CRC-32C that ``get_tensor`` verifies.

Covered: float32, float64, float16, int8, int16, int32, int64, uint8 and
bool tensors. String tensors (the object graph) are listed in the shape
map; reading one, a Snappy-compressed block or a sliced (partitioned)
entry raises NotImplementedError naming the file and key.
"""

import os
import re
import struct

import numpy as np

__all__ = ["crc32c", "masked_crc32c", "latest_checkpoint", "load_checkpoint",
           "BundleReader", "TABLE_MAGIC", "DTYPES"]

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
# TensorFlow's DataType enum -> numpy; 7 is DT_STRING
DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
          19: np.float16}
DT_STRING = 7
_MASK_DELTA = 0xA282EAD8

# ---- CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) ---------------


def _byte_table():
    table = []
    for n in range(256):
        for _ in range(8):
            n = (n >> 1) ^ 0x82F63B78 if n & 1 else n >> 1
        table.append(n)
    return table


_TABLE = _byte_table()


def crc32c(buf):
    """CRC-32C of ``buf`` (bytes-like): init and final xor 0xFFFFFFFF."""
    reg = 0xFFFFFFFF
    for b in memoryview(buf).cast("B"):
        reg = _TABLE[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg ^ 0xFFFFFFFF


def masked_crc32c(buf):
    """LevelDB's and TensorBundle's masked CRC-32C."""
    c = crc32c(buf)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + _MASK_DELTA) \
        & 0xFFFFFFFF


# ---- protobuf wire format, as far as the bundle needs it -----------------


def _varint(buf, pos):
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf):
    """(field number, wire type, value) of a message; a length-delimited
    value is its bytes, a fixed32 or fixed64 its integer."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        num, kind = tag >> 3, tag & 7
        if kind == 0:
            val, pos = _varint(buf, pos)
        elif kind == 2:
            size, pos = _varint(buf, pos)
            val, pos = bytes(buf[pos:pos + size]), pos + size
        elif kind == 5:
            val, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif kind == 1:
            val, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        else:
            raise ValueError(f"protobuf wire type {kind} not expected")
        yield num, kind, val


def _int64(v):
    return v - (1 << 64) if v >= 1 << 63 else v


def _shape(buf):
    """TensorShapeProto -> list of dims (-1 for unknown)."""
    dims = []
    for num, _, val in _fields(buf):
        if num == 2:  # Dim {int64 size = 1; string name = 2}
            size = 0
            for n2, _, v2 in _fields(val):
                if n2 == 1:
                    size = _int64(v2)
            dims.append(size)
    return dims


def _entry(buf):
    e = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0,
         "crc32c": None, "sliced": False}
    for num, _, val in _fields(buf):
        if num == 1:
            e["dtype"] = val
        elif num == 2:
            e["shape"] = _shape(val)
        elif num == 3:
            e["shard_id"] = val
        elif num == 4:
            e["offset"] = _int64(val)
        elif num == 5:
            e["size"] = _int64(val)
        elif num == 6:
            e["crc32c"] = val
        elif num == 7:
            e["sliced"] = True
    return e


# ---- the LevelDB table ---------------------------------------------------


def _block(data, handle, path):
    offset, size = handle
    block = data[offset:offset + size]
    kind = data[offset + size]
    crc = struct.unpack_from("<I", data, offset + size + 1)[0]
    if masked_crc32c(data[offset:offset + size + 1]) != crc:
        raise ValueError(f"{path}: block at offset {offset} fails its "
                         "CRC-32C")
    if kind == 1:
        raise NotImplementedError(
            f"{path}: the block at offset {offset} is Snappy-compressed; "
            "only uncompressed index blocks are read")
    if kind != 0:
        raise ValueError(f"{path}: block compression type {kind}")
    return block


def _block_entries(block):
    """(key, value) of a block's entries in order."""
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 * (n_restarts + 1)
    pos, key = 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        unshared, pos = _varint(block, pos)
        size, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + unshared])
        pos += unshared
        yield key, bytes(block[pos:pos + size])
        pos += size


def _handle(buf, pos=0):
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return (offset, size), pos


def _read_table(path):
    """{key: value} of every entry of a table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: too short for a table footer")
    footer = data[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, 40)[0] != TABLE_MAGIC:
        raise ValueError(f"{path}: not a TensorBundle index (bad magic)")
    _, pos = _handle(footer)  # the meta-index, which holds nothing needed
    index_handle, _ = _handle(footer, pos)
    out = {}
    for _, value in _block_entries(_block(data, index_handle, path)):
        handle, _ = _handle(value)
        out.update(_block_entries(_block(data, handle, path)))
    return out


# ---- the reader ----------------------------------------------------------


class BundleReader:
    """The numpy counterpart of TensorFlow's CheckpointReader."""

    def __init__(self, prefix):
        self.prefix = prefix
        self.index_path = prefix + ".index"
        table = _read_table(self.index_path)
        header = dict((n, v) for n, _, v in _fields(table.pop(b"", b"")))
        self.num_shards = header.get(1, 1)
        if header.get(2, 0) != 0:
            raise NotImplementedError(
                f"{self.index_path}: a big-endian bundle")
        self._entries = {k.decode(): _entry(v) for k, v in table.items()}

    def get_variable_to_shape_map(self):
        return {k: list(e["shape"]) for k, e in self._entries.items()}

    def shard_path(self, shard_id):
        return "%s.data-%05d-of-%05d" % (self.prefix, shard_id,
                                          self.num_shards)

    def get_tensor(self, key):
        if key not in self._entries:
            raise KeyError(f"{key!r} not in checkpoint {self.prefix}")
        e = self._entries[key]
        path = self.shard_path(e["shard_id"])
        if e["sliced"]:
            raise NotImplementedError(
                f"{path}: {key!r} is a sliced (partitioned) variable")
        if e["dtype"] not in DTYPES:
            what = "a string tensor" if e["dtype"] == DT_STRING \
                else f"of TensorFlow dtype {e['dtype']}"
            raise NotImplementedError(f"{path}: {key!r} is {what}")
        with open(path, "rb") as f:
            f.seek(e["offset"])
            buf = f.read(e["size"])
        if len(buf) != e["size"]:
            raise ValueError(f"{path}: {key!r} runs past the end of the "
                             "file")
        if e["crc32c"] is not None and masked_crc32c(buf) != e["crc32c"]:
            raise ValueError(f"{path}: {key!r} fails its CRC-32C")
        dtype = np.dtype(DTYPES[e["dtype"]]).newbyteorder("<")
        return np.frombuffer(buf, dtype).astype(
            dtype.newbyteorder("=")).reshape(e["shape"])


def latest_checkpoint(checkpoint_dir):
    """The prefix that ``checkpoint_dir``'s "checkpoint" file names as
    model_checkpoint_path (relative to the directory unless absolute),
    where its index exists; else None, as tf.train.latest_checkpoint."""
    state = os.path.join(checkpoint_dir, "checkpoint")
    if not os.path.exists(state):
        return None
    with open(state) as f:
        m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"',
                      f.read(), re.M)
    if not m:
        return None
    prefix = m.group(1).encode().decode("unicode_escape")
    if not os.path.isabs(prefix):
        prefix = os.path.join(checkpoint_dir, prefix)
    return prefix if os.path.exists(prefix + ".index") else None


def load_checkpoint(ckpt_dir_or_file):
    """A BundleReader of a prefix, or of a directory's latest checkpoint,
    as tf.train.load_checkpoint."""
    prefix = ckpt_dir_or_file
    if os.path.isdir(prefix):
        prefix = latest_checkpoint(prefix)
        if prefix is None:
            raise ValueError(f"no checkpoint in {ckpt_dir_or_file}")
    return BundleReader(prefix)

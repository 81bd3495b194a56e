"""Rosbag (v2.0) streaming datasets — pure Python, no ROS installation.

The port's own copy of ``pwclonet_pylidarslam_tpu/data/rosbag.py`` (host
numpy and scipy; lz4 chunks need the ``lz4`` package, imported when a bag
holds one).

The reference wraps the ROS ``rosbag`` python package and gates the feature
on its availability (``slam/dataset/rosbag_dataset.py:26-33``). Here the bag
format itself is parsed directly (it is a simple documented record container),
so PointCloud2 streams work in any environment:

- ``BagReader`` — sequential record parser for the rosbag 2.0 on-disk format
  (records, connections, chunks with none/bz2/lz4 compression);
- ``decode_pointcloud2`` — sensor_msgs/PointCloud2 → numpy, arbitrary field
  layouts via a structured dtype (replaces ``sensor_msgs.point_cloud2``);
- ``RosbagSequence`` — SequenceSource over a bag's main point-cloud topic,
  accumulating ``frame_size`` messages per frame
  (ref ``RosbagDataset.__getitem__``, rosbag_dataset.py:139-158);
- ``UrbanLocoSequence`` — UrbanLoco acquisition handling (HONG_KONG
  /velodyne_points vs CALIFORNIA /rslidar_points, packet-derived per-point
  timestamps, azimuth-synchronized frame cuts)
  (ref ``urban_loco_dataset.py:175-330``);
- ``write_bag`` — minimal writer used by tests/fixtures.

Bags are sequential containers; frames are decoded in order and cached, so
``scan(i)`` supports the runner's forward iteration at no extra cost.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

# sensor_msgs/PointField datatype codes
_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


# ---------------------------------------------------------------------------
# Low-level record parsing
# ---------------------------------------------------------------------------


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """A record header is a sequence of ``len(name=value)`` fields."""
    fields = {}
    off = 0
    while off + 4 <= len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1 :]
    return fields


def _iter_records(buf: bytes, offset: int = 0) -> Iterator[Tuple[Dict, bytes]]:
    """Yield ``(header_fields, data)`` for each record in ``buf``."""
    n = len(buf)
    while offset + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        header = _parse_header(buf[offset : offset + hlen])
        offset += hlen
        (dlen,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        data = buf[offset : offset + dlen]
        offset += dlen
        yield header, data


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    message_definition: str = ""  # embedded .msg text (for generic decoding)


class BagReader:
    """Sequential reader for rosbag 2.0 files.

    ``read_messages(topics)`` yields ``(topic, msg_type, raw_bytes, t_sec)``
    in stored order, descending into chunk records (compression: none, bz2,
    and lz4 when the ``lz4`` package exists).
    """

    def __init__(self, path: str):
        self.path = Path(path)
        raw = self.path.read_bytes()
        if not raw.startswith(_MAGIC):
            raise ValueError(f"{path} is not a rosbag 2.0 file")
        self._buf = raw[len(_MAGIC) :]
        self.connections: Dict[int, Connection] = {}

    def _decompress(self, compression: bytes, data: bytes) -> bytes:
        if compression in (b"none", b""):
            return data
        if compression == b"bz2":
            return bz2.decompress(data)
        if compression == b"lz4":
            try:
                import lz4.frame  # type: ignore
            except ImportError as exc:  # pragma: no cover - env without lz4
                raise RuntimeError("bag uses lz4 chunks but lz4 is unavailable") from exc
            return lz4.frame.decompress(data)
        raise ValueError(f"unknown chunk compression {compression!r}")

    def _handle(self, header: Dict, data: bytes):
        """Process one record; yields message tuples for op=2."""
        op = header.get(b"op", b"\x00")[0]
        if op == 0x07:  # connection
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            conn_hdr = _parse_header(data)
            self.connections[conn_id] = Connection(
                conn_id,
                header.get(b"topic", conn_hdr.get(b"topic", b"")).decode(),
                conn_hdr.get(b"type", b"").decode(),
                conn_hdr.get(b"message_definition", b"").decode(errors="replace"),
            )
        elif op == 0x02:  # message data
            conn_id = struct.unpack("<I", header[b"conn"])[0]
            secs, nsecs = struct.unpack("<II", header[b"time"])
            conn = self.connections.get(conn_id)
            if conn is not None:
                yield conn.topic, conn.msg_type, data, secs + nsecs * 1e-9
        elif op == 0x05:  # chunk — recurse into the decompressed payload
            payload = self._decompress(header.get(b"compression", b"none"), data)
            for hdr, dat in _iter_records(payload):
                yield from self._handle(hdr, dat)
        # ops 0x03 (bag header), 0x04 (index), 0x06 (chunk info): skipped

    def read_messages(
        self, topics: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, str, bytes, float]]:
        for header, data in _iter_records(self._buf):
            for msg in self._handle(header, data):
                if topics is None or msg[0] in topics:
                    yield msg

    def topic_info(self) -> Dict[str, str]:
        """topic → message type (scans the whole bag once)."""
        for _ in self.read_messages():
            pass
        return {c.topic: c.msg_type for c in self.connections.values()}


# ---------------------------------------------------------------------------
# Generic ROS1 message decoding from the embedded .msg definition
# ---------------------------------------------------------------------------

# struct format + size per ROS primitive
_PRIMITIVES = {
    "bool": ("<B", 1), "byte": ("<b", 1), "char": ("<B", 1),
    "int8": ("<b", 1), "uint8": ("<B", 1),
    "int16": ("<h", 2), "uint16": ("<H", 2),
    "int32": ("<i", 4), "uint32": ("<I", 4),
    "int64": ("<q", 8), "uint64": ("<Q", 8),
    "float32": ("<f", 4), "float64": ("<d", 8),
}

_HEADER_FIELDS = [("uint32", "seq", None), ("time", "stamp", None),
                  ("string", "frame_id", None)]


def parse_message_definition(defn: str) -> Dict[str, list]:
    """Parse the ``message_definition`` text a bag stores per connection into
    ``{type_name: [(field_type, field_name, array_len), ...]}``.

    The top-level message is keyed ``""``; embedded sub-message definitions
    (after ``===`` separator lines, each starting ``MSG: pkg/Type``) are keyed
    by their full type name. ``array_len`` is None for scalars, -1 for
    variable-length arrays, else the fixed length. Constants are skipped.
    """
    import re

    sections = re.split(r"^=+\s*$", defn, flags=re.M)
    out: Dict[str, list] = {}
    for i, sec in enumerate(sections):
        lines = [ln.split("#", 1)[0].strip() for ln in sec.strip().splitlines()]
        lines = [ln for ln in lines if ln]
        name = ""
        if i > 0:
            if not lines or not lines[0].startswith("MSG:"):
                continue
            name = lines[0].split("MSG:", 1)[1].strip()
            lines = lines[1:]
        fields = []
        for ln in lines:
            if "=" in ln:  # constant declaration, e.g. "uint8 FOO=1"
                continue
            parts = ln.split()
            if len(parts) < 2:
                continue
            ftype, fname = parts[0], parts[1]
            alen = None
            m = re.match(r"(.+)\[(\d*)\]$", ftype)
            if m:
                ftype = m.group(1)
                alen = int(m.group(2)) if m.group(2) else -1
            fields.append((ftype, fname, alen))
        out[name] = fields
    return out


def decode_message(raw: bytes, definition: str) -> Dict:
    """Decode a serialized ROS1 message body into nested plain dicts using its
    embedded ``.msg`` definition (replaces ``rosbag``'s genpy deserializer for
    plain-field messages like novatel INSPVAX)."""
    defn_map = parse_message_definition(definition)

    def resolve(t: str) -> list:
        if t in ("Header", "std_msgs/Header"):
            return defn_map.get("std_msgs/Header", _HEADER_FIELDS)
        if t in defn_map:
            return defn_map[t]
        for k in defn_map:  # unqualified references to embedded types
            if k.endswith("/" + t):
                return defn_map[k]
        raise KeyError(f"message definition lacks embedded type {t!r}")

    def read_value(t: str, off: int):
        if t in _PRIMITIVES:
            fmt, size = _PRIMITIVES[t]
            v = struct.unpack_from(fmt, raw, off)[0]
            return (bool(v) if t == "bool" else v), off + size
        if t in ("time", "duration"):
            fmt = "<II" if t == "time" else "<ii"
            s, ns = struct.unpack_from(fmt, raw, off)
            return s + ns * 1e-9, off + 8
        if t == "string":
            (n,) = struct.unpack_from("<I", raw, off)
            return raw[off + 4 : off + 4 + n].decode(errors="replace"), off + 4 + n
        return read_struct(resolve(t), off)

    def read_struct(fields: list, off: int):
        d = {}
        for ftype, fname, alen in fields:
            if alen is None:
                d[fname], off = read_value(ftype, off)
            else:
                n = alen
                if n == -1:
                    (n,) = struct.unpack_from("<I", raw, off)
                    off += 4
                vals = []
                for _ in range(n):
                    v, off = read_value(ftype, off)
                    vals.append(v)
                d[fname] = vals
        return d, off

    out, _ = read_struct(defn_map.get("", []), 0)
    return out


# ---------------------------------------------------------------------------
# sensor_msgs/PointCloud2 decode / encode
# ---------------------------------------------------------------------------


def _read_string(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    return buf[off + 4 : off + 4 + n].decode(), off + 4 + n


def decode_pointcloud2(
    raw: bytes, want_fields: Tuple[str, ...] = ("x", "y", "z")
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Decode a serialized PointCloud2 into ``(points (N,len(want_fields)),
    per_point_time or None)``.

    Any per-point time field (``time``/``t``/``timestamp``/``time_offset``)
    is returned normalized as float64 when present.
    """
    off = 0
    (_seq,) = struct.unpack_from("<I", raw, off)
    off += 4
    _secs, _nsecs = struct.unpack_from("<II", raw, off)
    off += 8
    _frame_id, off = _read_string(raw, off)
    height, width = struct.unpack_from("<II", raw, off)
    off += 8
    (n_fields,) = struct.unpack_from("<I", raw, off)
    off += 4
    fields = []
    for _ in range(n_fields):
        name, off = _read_string(raw, off)
        f_off, dtype, count = struct.unpack_from("<IBI", raw, off)
        off += 9
        fields.append((name, f_off, dtype, count))
    (is_bigendian,) = struct.unpack_from("<B", raw, off)
    off += 1
    point_step, _row_step = struct.unpack_from("<II", raw, off)
    off += 8
    (data_len,) = struct.unpack_from("<I", raw, off)
    off += 4
    data = raw[off : off + data_len]
    off += data_len

    n_points = (height * width) if point_step == 0 else len(data) // point_step
    endian = ">" if is_bigendian else "<"
    arr = np.frombuffer(data[: n_points * point_step], dtype=np.uint8).reshape(
        n_points, point_step
    )

    def extract(name: str) -> Optional[np.ndarray]:
        for fname, foff, fdtype, _count in fields:
            if fname == name:
                dt = np.dtype(_PF_DTYPES[fdtype]).newbyteorder(endian)
                col = arr[:, foff : foff + dt.itemsize]
                return np.ascontiguousarray(col).view(dt)[:, 0]
        return None

    cols = []
    for name in want_fields:
        col = extract(name)
        if col is None:
            raise ValueError(f"PointCloud2 has no field {name!r}")
        cols.append(col.astype(np.float32))
    pts = np.stack(cols, axis=-1)

    times = None
    for tname in ("time", "t", "timestamp", "time_offset"):
        col = extract(tname)
        if col is not None:
            times = col.astype(np.float64)
            break
    return pts, times


def encode_pointcloud2(
    points: np.ndarray, frame_id: str = "lidar", times: Optional[np.ndarray] = None
) -> bytes:
    """Serialize ``(N, 3)`` float32 points (+ optional per-point ``time``
    float32 field) as a PointCloud2 message body."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    point_step = 12
    payload = points.astype("<f4").tobytes()
    if times is not None:
        fields.append(("time", 12, 7, 1))
        point_step = 16
        rec = np.zeros((n, 4), "<f4")
        rec[:, :3] = points
        rec[:, 3] = np.asarray(times, np.float32)
        payload = rec.tobytes()

    out = bytearray()
    out += struct.pack("<I", 0)  # header.seq
    out += struct.pack("<II", 0, 0)  # header.stamp
    out += struct.pack("<I", len(frame_id)) + frame_id.encode()
    out += struct.pack("<II", 1, n)  # height, width
    out += struct.pack("<I", len(fields))
    for name, foff, dtype, count in fields:
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", foff, dtype, count)
    out += struct.pack("<B", 0)  # is_bigendian
    out += struct.pack("<II", point_step, point_step * n)
    out += struct.pack("<I", len(payload)) + payload
    out += struct.pack("<B", 1)  # is_dense
    return bytes(out)


# ---------------------------------------------------------------------------
# Minimal bag writer (fixtures / export)
# ---------------------------------------------------------------------------


def _record(header_fields: Dict[bytes, bytes], data: bytes) -> bytes:
    header = b"".join(
        struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
        for k, v in header_fields.items()
    )
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def write_bag(
    path: str,
    messages: List[Tuple[str, str, bytes, float]],
    compression: str = "none",
    definitions: Optional[Dict[str, str]] = None,
) -> None:
    """Write ``(topic, msg_type, raw, t_sec)`` messages into a rosbag 2.0
    file (one chunk; compression "none" or "bz2"). ``definitions`` optionally
    maps topics to their ``.msg`` definition text (needed for generic decode
    of non-PointCloud2 topics)."""
    topics = {}
    for topic, msg_type, _raw, _t in messages:
        topics.setdefault(topic, msg_type)
    conn_ids = {topic: i for i, topic in enumerate(topics)}

    chunk = bytearray()
    for topic, conn_id in conn_ids.items():
        defn = (definitions or {}).get(topic, "")
        data = b"".join(
            struct.pack("<I", len(k) + 1 + len(v)) + k + b"=" + v
            for k, v in {
                b"topic": topic.encode(),
                b"type": topics[topic].encode(),
                b"md5sum": b"0" * 32,
                b"message_definition": defn.encode(),
            }.items()
        )
        chunk += _record(
            {
                b"op": b"\x07",
                b"conn": struct.pack("<I", conn_id),
                b"topic": topic.encode(),
            },
            data,
        )
    for topic, _msg_type, raw, t in messages:
        secs = int(t)
        nsecs = int(round((t - secs) * 1e9))
        chunk += _record(
            {
                b"op": b"\x02",
                b"conn": struct.pack("<I", conn_ids[topic]),
                b"time": struct.pack("<II", secs, nsecs),
            },
            raw,
        )

    payload = bytes(chunk)
    if compression == "bz2":
        payload = bz2.compress(payload)
    elif compression != "none":
        raise ValueError(f"unsupported writer compression {compression!r}")

    out = bytearray()
    out += _MAGIC
    # bag header record, padded to 4096 like real bags
    bag_hdr = _record(
        {
            b"op": b"\x03",
            b"index_pos": struct.pack("<Q", 0),
            b"conn_count": struct.pack("<I", len(conn_ids)),
            b"chunk_count": struct.pack("<I", 1),
        },
        b" " * 4096,
    )
    out += bag_hdr
    out += _record(
        {
            b"op": b"\x05",
            b"compression": compression.encode(),
            b"size": struct.pack("<I", len(chunk)),
        },
        payload,
    )
    Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# SequenceSource over a bag
# ---------------------------------------------------------------------------


class RosbagSequence:
    """Point-cloud frames from a bag's main topic (SequenceSource protocol).

    ``frame_size`` consecutive PointCloud2 messages are concatenated into one
    frame (the reference's ``accumulate_scans``/``frame_size`` semantics,
    rosbag_dataset.py:139-158). Frames decode lazily, in order, and cache.
    """

    def __init__(
        self,
        file_path: str,
        main_topic: str,
        frame_size: int = 1,
        num_points: Optional[int] = None,
    ):
        self.reader = BagReader(file_path)
        self.main_topic = main_topic
        self.frame_size = max(1, frame_size)
        self.num_points = num_points
        self._msgs = None  # lazy message iterator
        self._frames: List[np.ndarray] = []
        self._times: List[Optional[np.ndarray]] = []
        self._bag_times: List[float] = []  # bag record time per frame (s)
        self._count: Optional[int] = None

    def __len__(self) -> int:
        if self._count is None:
            n_msgs = sum(1 for _ in self.reader.read_messages([self.main_topic]))
            self._count = n_msgs // self.frame_size
        return self._count

    def _decode_next(self) -> bool:
        if self._msgs is None:
            self._msgs = self.reader.read_messages([self.main_topic])
        pcs, times = [], []
        bag_t = 0.0
        for _ in range(self.frame_size):
            try:
                _topic, _mtype, raw, bag_t = next(self._msgs)
            except StopIteration:
                return False
            pc, ts = decode_pointcloud2(raw)
            pcs.append(pc)
            times.append(ts)
        pc = np.concatenate(pcs, axis=0)
        self._bag_times.append(bag_t)
        ts = (
            np.concatenate([t for t in times if t is not None])
            if any(t is not None for t in times)
            else None
        )
        pc, ts = self._postprocess(pc, ts)
        self._frames.append(pc)
        self._times.append(ts)
        return True

    def _postprocess(self, pc, ts):
        finite = np.all(np.isfinite(pc), axis=-1)
        pc = pc[finite]
        if ts is not None:
            ts = ts[finite]
            lo, hi = ts.min(), ts.max()
            if hi > lo:
                ts = (ts - lo) / (hi - lo)
        if self.num_points is not None and pc.shape[0] > self.num_points:
            sel = np.random.default_rng(len(self._frames)).choice(
                pc.shape[0], self.num_points, replace=False
            )
            pc, ts = pc[sel], (None if ts is None else ts[sel])
        return pc, ts

    def scan(self, idx: int) -> np.ndarray:
        while len(self._frames) <= idx:
            if not self._decode_next():
                raise IndexError(idx)
        return self._frames[idx]

    def timestamps(self, idx: int) -> Optional[np.ndarray]:
        self.scan(idx)
        return self._times[idx]

    def ground_truth(self) -> Optional[np.ndarray]:
        return None  # bags carry no poses (ref rosbag_dataset.py:213-215)


def lla_to_ecef(lon_deg: float, lat_deg: float, alt: float) -> np.ndarray:
    """WGS84 geodetic → ECEF (standard ellipsoid formulas; the reference's
    ``llu_to_ecef``, urban_loco_dataset.py:123-139)."""
    a, b = 6378137.0, 6356752.314
    lon, lat = np.deg2rad(lon_deg), np.deg2rad(lat_deg)
    n = a * a / np.sqrt(a * a * np.cos(lat) ** 2 + b * b * np.sin(lat) ** 2)
    return np.array(
        [
            (n + alt) * np.cos(lat) * np.cos(lon),
            (n + alt) * np.cos(lat) * np.sin(lon),
            (b * b / (a * a) * n + alt) * np.sin(lat),
        ]
    )


def ecef_to_enu(origin_lla: np.ndarray, ecef: np.ndarray) -> np.ndarray:
    """ECEF → local East/North/Up at ``origin_lla = (lon, lat, alt)`` degrees
    (ref ``ecef_to_enu``, urban_loco_dataset.py:141-173)."""
    d = ecef - lla_to_ecef(*origin_lla)
    lon, lat = np.deg2rad(origin_lla[0]), np.deg2rad(origin_lla[1])
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    return np.array(
        [
            -sl * d[0] + cl * d[1],
            -sp * cl * d[0] - sp * sl * d[1] + cp * d[2],
            cp * cl * d[0] + cp * sl * d[1] + sp * d[2],
        ]
    )


# ENU → NWU (North/West/Up) axis permutation (ref urban_loco_dataset.py:510-515)
_ENU_TO_NWU = np.array(
    [[0.0, 1.0, 0.0, 0.0], [-1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
)


class UrbanLocoSequence(RosbagSequence):
    """UrbanLoco bags (ref ``urban_loco_dataset.py:175-368``).

    - acquisition HONG_KONG → topic ``/velodyne_points``; CALIFORNIA →
      ``/rslidar_points`` (ref ``pointcloud_topic``, :204-208);
    - CALIFORNIA per-point timestamps derived from the RS-LiDAR packet
      structure (12 blocks × 32 lasers per packet, ref
      ``estimate_timestamps``, :221-228); HONG_KONG falls back to the
      azimuth estimate (the reference's ring-id reconstruction feeds the
      same de-skew purpose);
    - ``ground_truth()`` decodes the novatel INSPVAX GPS/INS stream
      (``/novatel_data/inspvax``) through the generic message decoder:
      geodetic fix → ENU (first fix as origin) → NWU, azimuth/pitch/roll →
      rotation, interpolated at each scan's bag time and rebased to the
      first scan (ref ``generate_ground_truth``, urban_loco_dataset.py:430-530).
    """

    HONG_KONG = "hong_kong"
    CALIFORNIA = "california"

    TOPICS = {HONG_KONG: "/velodyne_points", CALIFORNIA: "/rslidar_points"}
    GT_TOPIC = "/novatel_data/inspvax"  # ref ground_truth_topic, :211-213

    def __init__(
        self,
        file_path: str,
        acquisition: str = HONG_KONG,
        num_points: Optional[int] = None,
    ):
        if acquisition not in self.TOPICS:
            raise ValueError(f"unknown acquisition {acquisition!r}")
        self.acquisition = acquisition
        self._gt: Optional[np.ndarray] = None
        super().__init__(
            file_path, self.TOPICS[acquisition], frame_size=1, num_points=num_points
        )

    def _postprocess(self, pc, ts):
        finite = np.all(np.isfinite(pc), axis=-1)
        pc = pc[finite]
        if self.acquisition == self.CALIFORNIA:
            # packet-position timestamps: RS-LiDAR packs 12 blocks x 32 rays
            n = pc.shape[0]
            packet = np.arange(n, dtype=np.float64) // (12 * 32)
            ts = packet / max(packet.max(), 1.0)
        else:
            phi = np.arctan2(pc[:, 1], pc[:, 0])
            ts = np.clip((np.pi - phi) / (2 * np.pi), 0.0, 1.0)
        if self.num_points is not None and pc.shape[0] > self.num_points:
            sel = np.random.default_rng(len(self._frames)).choice(
                pc.shape[0], self.num_points, replace=False
            )
            pc, ts = pc[sel], ts[sel]
        return pc, ts

    def _inspvax_poses(self) -> Tuple[np.ndarray, np.ndarray]:
        """All INSPVAX fixes → ``(timestamps (N,), NWU poses (N, 4, 4))``
        rebased so the first fix is identity (ref :472-520)."""
        from scipy.spatial.transform import Rotation

        stamps, poses = [], []
        init_lla = None
        init_enu = None
        for _topic, _mtype, raw, t in self.reader.read_messages([self.GT_TOPIC]):
            conn = next(
                c for c in self.reader.connections.values() if c.topic == self.GT_TOPIC
            )
            msg = decode_message(raw, conn.message_definition)
            lla = np.array([msg["longitude"], msg["latitude"], msg["altitude"]])
            yaw = np.deg2rad(msg["azimuth"])
            pitch = np.deg2rad(msg["pitch"])
            roll = np.deg2rad(msg["roll"])
            # azimuth is clockwise-from-north; ENU heading is −azimuth (ref :485)
            r_enu = Rotation.from_euler("zyx", [-yaw, pitch, roll]).as_matrix()
            if init_lla is None:
                init_lla = lla
            enu = ecef_to_enu(init_lla, lla_to_ecef(*lla))
            if init_enu is None:
                init_enu = enu
            pose = np.eye(4)
            pose[:3, :3] = r_enu
            pose[:3, 3] = enu - init_enu
            # conjugate into NWU (ref :510-516)
            pose = _ENU_TO_NWU @ pose @ np.linalg.inv(_ENU_TO_NWU)
            stamps.append(t)
            poses.append(pose)
        if not poses:
            return np.zeros((0,)), np.zeros((0, 4, 4))
        poses = np.stack(poses)
        poses = np.linalg.inv(poses[0])[None] @ poses  # rebase to first fix
        return np.asarray(stamps), poses

    def ground_truth(self) -> Optional[np.ndarray]:
        """Absolute GT pose per scan frame ``(T, 4, 4)`` (first frame =
        identity), or None when the bag has no INSPVAX stream."""
        if self._gt is not None:
            return self._gt
        stamps, poses = self._inspvax_poses()
        if len(poses) < 2:
            return None
        n = len(self)
        while len(self._bag_times) < n:  # decode all frames for their times
            if not self._decode_next():
                break
        scan_times = np.asarray(self._bag_times)
        interp = _interpolate_poses(stamps, poses, scan_times)
        interp = np.linalg.inv(interp[0])[None] @ interp  # rebase to 1st scan
        self._gt = interp
        return self._gt

    def gps_poses(self) -> Optional[np.ndarray]:
        """Per-scan GPS/INS pose measurements ``(T, 4, 4)`` for unary pose-graph
        priors — the INSPVAX stream interpolated at scan times, i.e. the same
        measurements the reference harvests as ``se3_absolute_constraint_<i>``
        (ref ``backend.py:83,104-106,275-330``; the reference's GPS constraints
        and its UrbanLoco ground truth are one and the same INSPVAX stream)."""
        return self.ground_truth()


def _interpolate_poses(
    stamps: np.ndarray, poses: np.ndarray, query: np.ndarray
) -> np.ndarray:
    """Slerp rotations + lerp translations of ``poses`` at ``query`` times,
    clamped to the covered interval (the reference's ``PosesInterpolator``,
    slam/common/pose.py:23-52)."""
    from scipy.spatial.transform import Rotation, Slerp

    order = np.argsort(stamps)
    stamps, poses = stamps[order], poses[order]
    # drop duplicate timestamps (Slerp requires strictly increasing keys)
    keep = np.concatenate([[True], np.diff(stamps) > 0])
    stamps, poses = stamps[keep], poses[keep]
    q = np.clip(query, stamps[0], stamps[-1])
    slerp = Slerp(stamps, Rotation.from_matrix(poses[:, :3, :3]))
    out = np.tile(np.eye(4), (len(q), 1, 1))
    out[:, :3, :3] = slerp(q).as_matrix()
    for axis in range(3):
        out[:, axis, 3] = np.interp(q, stamps, poses[:, axis, 3])
    return out

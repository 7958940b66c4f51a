"""Automatic prefix caching (APC): a host pool of prompt K/V.

Port of mlx_vlm_tpu/apc.py (_hash :34, semantic_extra_hash :42, the media
rules :59-101, APCBlock :104, APCStats :115, DiskBlockStore :142,
ShardedDiskStore :259, ExactDiskStore :565, APCManager :655, from_env
:971).  Hashes, stats, eviction order, pinning and the disk layouts are
the reference's, byte for byte.

Block mode (a plain `KVCache` / `BatchKVCache`): a prompt's K/V rows are
cut into blocks of `block_size` tokens, keyed by a chained sha256 of the
tokens and a salt (the model and the media: `semantic_extra_hash`), and
kept in host RAM as numpy arrays [L, H, block_size, D].  A block of a
bfloat16 cache is a uint16 array of the bf16 bits (the way the loader reads
BF16, with no `ml_dtypes`): its bytes equal the reference's bf16 block's.
`commit` copies the missing rows device -> host once, and waits for the
copy, since the decode that follows writes the same buffers in place.
`make_warm_cache` builds a fresh cache by `make_cache`, writes rows
[0, prefix) by index and sets its device cursor to the prefix.

Exact mode (the quantized caches): `store_exact` keeps a host snapshot of
the whole cache (core/cache.py `snapshot`), `lookup_exact` returns the
longest stored prefix as a cache of fresh device tensors (`restore`).
A snapshot records the capacity its own buffers hold, not the caller's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BLOCK_SIZE = 16
DEFAULT_NUM_BLOCKS = 2048


def _hash(parent: Optional[str], tokens: Tuple[int, ...], extra: str = "") -> str:
    h = hashlib.sha256()
    h.update((parent or "").encode())
    h.update(np.asarray(tokens, np.int64).tobytes())
    h.update(extra.encode())
    return h.hexdigest()


def semantic_extra_hash(
    model_key: str = "",
    images: Optional[Sequence[Any]] = None,
    tenant: str = "",
) -> str:
    """Multimodal-aware salt: the same tokens with other media must not
    collide.  Every byte of each array and its shape go in; the reference
    reads the first 64 KiB of each (so two clips or screenshots that open
    alike collide there), and on arrays within those 64 KiB the two salts
    are equal."""
    h = hashlib.sha256()
    h.update(model_key.encode())
    h.update(tenant.encode())
    for im in images or []:
        arr = np.asarray(im)
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        h.update(str(arr.shape).encode())
    return h.hexdigest()


# prepare_inputs' media arrays that a prompt's salt reads, in this order
MEDIA_KEYS = ("pixel_values", "image_grid_thw", "pixel_values_videos",
              "video_grid_thw")


def prompt_key(model, inputs: dict) -> Tuple[List[int], str]:
    """A prompt's token ids and its salt: `semantic_extra_hash` of the model
    type and prepare_inputs' media arrays (MEDIA_KEYS: the image's pixels
    and grid, the video's pixels and grid), where the reference's
    stream_generate (dispatch.py:156-160) and server (engine.py:280-289)
    hash the image's pixels alone, and no video."""
    extra = semantic_extra_hash(
        model_key=str(getattr(model, "config_dict", {}).get("model_type", "")),
        images=[np.asarray(inputs[k]) for k in MEDIA_KEYS
                if inputs.get(k) is not None] or None)
    return np.asarray(inputs["input_ids"])[0].tolist(), extra


def media_token_spans(tokens: Sequence[int], media_ids: Sequence[int]) -> List[Tuple[int, int]]:
    """Contiguous spans of media tokens."""
    spans = []
    start = None
    mset = set(media_ids)
    for i, t in enumerate(tokens):
        if t in mset:
            if start is None:
                start = i
        elif start is not None:
            spans.append((start, i))
            start = None
    if start is not None:
        spans.append((start, len(tokens)))
    return spans


def adjust_prefix_to_media_boundary(
    prefix_len: int, tokens: Sequence[int], media_ids: Sequence[int]
) -> int:
    """Shrink a prefix so that it never splits a media span."""
    for s, e in media_token_spans(tokens, media_ids):
        if s < prefix_len < e:
            return s
    return prefix_len


def media_safe_prefix_min(tokens: Sequence[int], media_ids: Sequence[int]) -> int:
    """The least prefix that leaves a text-only suffix: the end of the last
    media span."""
    spans = media_token_spans(tokens, media_ids)
    return max((e for _, e in spans), default=0)


def prefix_leaves_text_only_suffix(
    tokens: Sequence[int], prefix_len: int, media_ids: Sequence[int]
) -> bool:
    return int(prefix_len) >= media_safe_prefix_min(tokens, media_ids)


def _dtype_name(a: np.ndarray) -> str:
    """A block array's element type: a uint16 block holds bfloat16 bits."""
    return "bfloat16" if a.dtype == np.uint16 else str(a.dtype)


def _np_dtype(name: str):
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _host(t) -> np.ndarray:
    """A host numpy copy of K/V rows (a tensor on any device, or an array);
    bfloat16 as uint16 bits.  A copy from the card waits for it."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host block rows as a tensor of `like`'s dtype on its device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    return t.to(like.device, like.dtype)


@dataclasses.dataclass
class APCBlock:
    hash: str
    parent: Optional[str]
    tokens: Tuple[int, ...]
    k: np.ndarray  # [L, H, bs, D]; uint16 for bfloat16 bits
    v: np.ndarray
    last_used: float = 0.0
    refs: int = 0


@dataclasses.dataclass
class APCStats:
    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    stores: int = 0
    evictions: int = 0
    rejects: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reject(self, reason: str):
        self.rejects[reason] = self.rejects.get(reason, 0) + 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _free_ram_bytes() -> int:
    """Available host RAM (the guard before disk restores)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 62  # unknown platform: never block


class _Writer:
    """A background thread that writes queued blocks, best effort: a write
    that fails is dropped (the RAM pool keeps the block)."""

    def _start_writer(self):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._writer = threading.Thread(target=self._write_loop, daemon=True)
        self._writer.start()

    def _write_loop(self):
        while True:
            block = self._q.get()
            try:
                if block is None:
                    return
                self._write(block)
            except Exception:  # noqa: BLE001 - best-effort tier
                pass
            finally:
                self._q.task_done()

    def flush(self, timeout: float = 10.0):
        """Wait for queued writes to complete (q.empty() turns true when the
        writer dequeues the last block, before it is written)."""
        deadline = time.time() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks and time.time() < deadline:
                self._q.all_tasks_done.wait(
                    max(0.0, min(0.1, deadline - time.time())))


class DiskBlockStore(_Writer):
    """SSD tier for KV blocks that survives a restart: one safetensors file
    per block (tensors "k" and "v", metadata "parent" and "tokens"),
    written by the port's own writer (utils/loader.py `write_safetensors`)
    on a background thread; LRU eviction by mtime under a byte budget.
    A bfloat16 block is stored as BF16, so files move between the port
    and the reference both ways."""

    def __init__(self, path: str, max_bytes: int = 8 * 1024**3):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_bytes = max_bytes
        self.writes = 0
        self.loads = 0
        self._start_writer()

    def _file(self, h: str) -> str:
        return os.path.join(self.path, f"block_{h}.safetensors")

    def put(self, block: APCBlock):
        self._q.put(block)

    def _write(self, block: APCBlock):
        from .utils.loader import write_safetensors

        meta = {
            "parent": block.parent or "",
            "tokens": json.dumps(list(block.tokens)),
        }
        bf16 = tuple(n for n, a in (("k", block.k), ("v", block.v))
                     if a.dtype == np.uint16)
        write_safetensors(self._file(block.hash), {"k": block.k, "v": block.v},
                          metadata=meta, bf16=bf16)
        self.writes += 1
        self._evict()

    def _evict(self):
        files = [
            (os.path.getmtime(f), os.path.getsize(f), f)
            for f in (os.path.join(self.path, n) for n in os.listdir(self.path))
            if f.endswith(".safetensors")
        ]
        total = sum(sz for _, sz, _ in files)
        for _, sz, f in sorted(files):
            if total <= self.max_bytes:
                break
            try:
                os.remove(f)
                total -= sz
            except OSError:
                pass

    def get(self, h: str) -> Optional[APCBlock]:
        from .utils.loader import read_safetensors, read_safetensors_metadata

        f = self._file(h)
        if not os.path.exists(f):
            return None
        try:
            meta = read_safetensors_metadata(f)
            arrs = {k: _host(v) for k, v in read_safetensors(f).items()}
            blk = APCBlock(
                hash=h,
                parent=meta.get("parent") or None,
                tokens=tuple(json.loads(meta.get("tokens", "[]"))),
                k=arrs["k"],
                v=arrs["v"],
                last_used=time.time(),
            )
            os.utime(f)  # LRU touch
            self.loads += 1
            return blk
        except Exception:  # noqa: BLE001
            return None

    def stats(self) -> dict:
        files = os.listdir(self.path)
        return {
            "disk_blocks": len(files),
            "disk_bytes": sum(
                os.path.getsize(os.path.join(self.path, f)) for f in files
            ),
            "disk_writes": self.writes,
            "disk_loads": self.loads,
        }


class ShardedDiskStore(_Writer):
    """Shard-file SSD tier: fixed-size block records appended to shard
    files, with an append-only JSONL index.  Each record is layer-major
    ([L, H, bs, D] C order, K then V); its shard records and `index.jsonl`
    are byte-equal to the reference's for the same blocks (a bfloat16
    block is recorded as "bfloat16").  A block read is one byte-range
    `np.memmap` slice; blocks committed in chain order land at consecutive
    slots, so `load_prefix` reads a prefix in one range per segment.  The
    index is rebuilt from `index.jsonl` on restart; shard files are
    evicted whole by mtime under the byte budget, and the index is then
    compacted.  A torn record (a crash mid-write) is truncated back to the
    last whole record before the next append."""

    MAGIC = "apc-shard-v1"

    def __init__(self, path: str, max_bytes: int = 8 * 1024**3,
                 blocks_per_shard: int = 256,
                 min_free_ram_bytes: int = 1 << 30):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_bytes = max_bytes
        self.blocks_per_shard = blocks_per_shard
        self.min_free_ram_bytes = min_free_ram_bytes
        self.writes = 0
        self.loads = 0
        self._meta: Optional[dict] = None  # {shape, dtype, rec_bytes}
        self._index: Dict[str, Tuple[int, int, Optional[str], Tuple[int, ...]]] = {}
        self._shard_fill: Dict[int, int] = {}
        self._index_dirty = False
        self._ilock = threading.RLock()
        self._load_index()
        self._start_writer()

    # ------------------------------------------------------------ layout
    def _shard_file(self, sid: int) -> str:
        return os.path.join(self.path, f"shard_{sid:06d}.bin")

    def _index_file(self) -> str:
        return os.path.join(self.path, "index.jsonl")

    def _rec_meta(self, block: APCBlock) -> dict:
        k = np.asarray(block.k)
        return {
            "magic": self.MAGIC,
            "shape": list(k.shape),  # [L, H, bs, D]
            "dtype": _dtype_name(k),
            "rec_bytes": 2 * k.nbytes,  # K then V, layer-major C-order
        }

    def _load_index(self):
        f = self._index_file()
        if not os.path.exists(f):
            return
        try:
            with open(f) as fh:
                for line in fh:
                    rec = json.loads(line)
                    if "magic" in rec:
                        self._meta = rec
                        continue
                    sid, slot = rec["sid"], rec["slot"]
                    if not os.path.exists(self._shard_file(sid)):
                        continue  # shard evicted after the index line
                    self._index[rec["h"]] = (
                        sid, slot, rec.get("p") or None,
                        tuple(rec.get("t", ())),
                    )
                    self._shard_fill[sid] = max(
                        self._shard_fill.get(sid, 0), slot + 1)
        except Exception:  # noqa: BLE001 - corrupt index: start fresh
            self._index.clear()
            self._shard_fill.clear()

    # ------------------------------------------------------------- write
    def put(self, block: APCBlock):
        if _free_ram_bytes() < self.min_free_ram_bytes:
            return  # free-RAM guard: don't grow the write queue
        self._q.put(block)

    def _write(self, block: APCBlock):
        k = np.ascontiguousarray(np.asarray(block.k))
        v = np.ascontiguousarray(np.asarray(block.v))
        with self._ilock:
            if block.hash in self._index:
                return
            if self._meta is None:
                self._meta = self._rec_meta(block)
                with open(self._index_file(), "a") as fh:
                    fh.write(json.dumps(self._meta) + "\n")
            if list(k.shape) != self._meta["shape"]:
                return  # another model or layout than this store's
            sid = max(self._shard_fill, default=0)
            if self._shard_fill.get(sid, 0) >= self.blocks_per_shard:
                sid += 1
            slot = self._shard_fill.get(sid, 0)
            rec_bytes = self._meta["rec_bytes"]
            fpath = self._shard_file(sid)
            with open(fpath, "r+b" if os.path.exists(fpath) else "wb") as fh:
                fh.seek(0, 2)
                if fh.tell() != slot * rec_bytes:
                    # a torn record: truncate back to the last aligned
                    # boundary, so that this and every later record land at
                    # slot * rec_bytes, where the index says they are
                    slot = fh.tell() // rec_bytes
                    fh.truncate(slot * rec_bytes)
                    fh.seek(slot * rec_bytes)
                fh.write(k.tobytes())
                fh.write(v.tobytes())
            self._shard_fill[sid] = slot + 1
            self._index[block.hash] = (
                sid, slot, block.parent, tuple(block.tokens))
            with open(self._index_file(), "a") as fh:
                fh.write(json.dumps({
                    "h": block.hash, "sid": sid, "slot": slot,
                    "p": block.parent or "", "t": list(block.tokens),
                }) + "\n")
            self.writes += 1
        self._evict()

    def _evict(self):
        with self._ilock:
            shards = sorted(self._shard_fill)
            total = sum(
                os.path.getsize(self._shard_file(s))
                for s in shards if os.path.exists(self._shard_file(s))
            )
            active = max(shards, default=0)
            for s in sorted(
                (s for s in shards if s != active),
                key=lambda s: os.path.getmtime(self._shard_file(s))
                if os.path.exists(self._shard_file(s)) else 0,
            ):
                if total <= self.max_bytes:
                    break
                f = self._shard_file(s)
                try:
                    total -= os.path.getsize(f)
                    os.remove(f)
                except OSError:
                    pass
                self._shard_fill.pop(s, None)
                self._index = {
                    h: e for h, e in self._index.items() if e[0] != s
                }
                self._index_dirty = True
            if self._index_dirty:
                self._compact_index()

    def _compact_index(self):
        """Rewrite index.jsonl with only the live entries (called under
        _ilock)."""
        tmp = self._index_file() + ".tmp"
        try:
            with open(tmp, "w") as fh:
                if self._meta is not None:
                    fh.write(json.dumps(self._meta) + "\n")
                for h, (sid, slot, parent, tokens) in self._index.items():
                    fh.write(json.dumps({
                        "h": h, "sid": sid, "slot": slot,
                        "p": parent or "", "t": list(tokens),
                    }) + "\n")
            os.replace(tmp, self._index_file())
            self._index_dirty = False
        except OSError:
            pass

    # -------------------------------------------------------------- read
    def _read_slots(self, sid: int, lo: int, hi: int) -> Optional[np.ndarray]:
        """One byte-range memmap read of records [lo, hi) in shard sid."""
        rec = self._meta["rec_bytes"]
        f = self._shard_file(sid)
        if not os.path.exists(f):
            return None
        if os.path.getsize(f) < hi * rec:
            return None
        mm = np.memmap(f, dtype=np.uint8, mode="r",
                       offset=lo * rec, shape=((hi - lo) * rec,))
        out = np.array(mm)  # copy out of the map
        del mm
        os.utime(f)  # LRU touch
        return out

    def get(self, h: str) -> Optional[APCBlock]:
        with self._ilock:
            entry = self._index.get(h)
            meta = self._meta
        if entry is None or meta is None:
            return None
        sid, slot, parent, tokens = entry
        raw = self._read_slots(sid, slot, slot + 1)
        if raw is None:
            return None
        shape = tuple(meta["shape"])
        half = meta["rec_bytes"] // 2
        dt = _np_dtype(meta["dtype"])
        k = np.frombuffer(raw[:half].tobytes(), dtype=dt).reshape(shape)
        v = np.frombuffer(raw[half:].tobytes(), dtype=dt).reshape(shape)
        self.loads += 1
        return APCBlock(hash=h, parent=parent, tokens=tokens,
                        k=k, v=v, last_used=time.time())

    def load_prefix(self, hashes: Sequence[str]):
        """One contiguous range read per segment of consecutive shard
        slots.  Returns (k [L, H, prefix, D], v), or None when a block is
        missing."""
        with self._ilock:
            entries = [self._index.get(h) for h in hashes]
            meta = self._meta
        if meta is None or any(e is None for e in entries):
            return None
        segments: List[Tuple[int, int, int]] = []  # (sid, lo, hi)
        for sid, slot, _, _ in entries:
            if segments and segments[-1][0] == sid and segments[-1][2] == slot:
                segments[-1] = (sid, segments[-1][1], slot + 1)
            else:
                segments.append((sid, slot, slot + 1))
        shape = tuple(meta["shape"])  # [L, H, bs, D]
        half = meta["rec_bytes"] // 2
        dt = _np_dtype(meta["dtype"])
        ks, vs = [], []
        for sid, lo, hi in segments:
            raw = self._read_slots(sid, lo, hi)
            if raw is None:
                return None
            for i in range(hi - lo):
                rec = raw[i * 2 * half:(i + 1) * 2 * half]
                ks.append(np.frombuffer(
                    rec[:half].tobytes(), dtype=dt).reshape(shape))
                vs.append(np.frombuffer(
                    rec[half:].tobytes(), dtype=dt).reshape(shape))
        self.loads += len(hashes)
        return np.concatenate(ks, axis=2), np.concatenate(vs, axis=2)

    def stats(self) -> dict:
        with self._ilock:
            files = [
                self._shard_file(s) for s in self._shard_fill
                if os.path.exists(self._shard_file(s))
            ]
            return {
                "disk_blocks": len(self._index),
                "disk_shards": len(files),
                "disk_bytes": sum(os.path.getsize(f) for f in files),
                "disk_writes": self.writes,
                "disk_loads": self.loads,
            }


class ExactDiskStore:
    """SSD tier for whole-prefix exact snapshots: one pickle per snapshot
    (core/cache.py `snapshot`: the cache dataclass with CPU tensors),
    written to a temporary file and renamed into place, with a `.meta`
    JSON of (key, token_len, capacity) so that lookups scan metadata
    without reading a payload; LRU eviction by mtime under a byte budget.

    Its records hold the port's cache classes and torch tensors, so they
    load only in the port (the reference's hold its own numpy pytrees).
    Unlike the reference, the payload is written outside the store's lock,
    which guards only the index and eviction."""

    def __init__(self, path: str, max_bytes: int = 4 * 1024**3):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.max_bytes = max_bytes
        self.lock = threading.Lock()
        # key -> (token_len, capacity)
        self.index: Dict[str, Tuple[int, Optional[int]]] = {}
        for fn in os.listdir(path):
            if fn.startswith("exact-") and fn.endswith(".meta"):
                try:
                    with open(os.path.join(path, fn)) as f:
                        m = json.load(f)
                    self.index[m["key"]] = (int(m["token_len"]),
                                            m.get("capacity"))
                except (OSError, ValueError, KeyError):
                    continue

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"exact-{key}.pkl")

    def put(self, key: str, token_len: int, capacity: Optional[int],
            snapshot) -> None:
        import pickle

        tmp = f"{self._file(key)}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snapshot, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._file(key))
        meta_tmp = os.path.join(self.path, f"exact-{key}.meta.tmp")
        with open(meta_tmp, "w") as f:
            json.dump({"key": key, "token_len": token_len,
                       "capacity": capacity}, f)
        os.replace(meta_tmp, os.path.join(self.path, f"exact-{key}.meta"))
        with self.lock:
            self.index[key] = (token_len, capacity)
            self._evict()

    def get(self, key: str):
        import pickle

        try:
            with open(self._file(key), "rb") as f:
                snap = pickle.load(f)
            os.utime(self._file(key))  # LRU touch
            return snap
        except (OSError, pickle.UnpicklingError, EOFError):
            with self.lock:
                self.index.pop(key, None)
            return None

    def lengths(self):
        with self.lock:
            return dict(self.index)

    def _evict(self):
        files = []
        total = 0
        for fn in os.listdir(self.path):
            if fn.startswith("exact-") and fn.endswith(".pkl"):
                fp = os.path.join(self.path, fn)
                try:
                    st = os.stat(fp)
                except OSError:
                    continue
                files.append((st.st_mtime, st.st_size, fp, fn))
                total += st.st_size
        files.sort()
        for _, size, fp, fn in files:
            if total <= self.max_bytes:
                break
            key = fn[len("exact-"):-len(".pkl")]
            for suffix in (".pkl", ".meta"):
                try:
                    os.remove(os.path.join(self.path, f"exact-{key}{suffix}"))
                except OSError:
                    pass
            self.index.pop(key, None)
            total -= size


class APCManager:
    """Fixed-size block pool with chained hashes and LRU eviction, and the
    exact-mode snapshot store.  `text_only_suffix` is the reference's media
    rule: the port embeds the whole prompt (vision included) before it
    slices at the prefix, so the rule is off by default."""

    def __init__(
        self,
        num_blocks: int = DEFAULT_NUM_BLOCKS,
        block_size: int = DEFAULT_BLOCK_SIZE,
        media_token_ids: Sequence[int] = (),
        disk_store: Optional["DiskBlockStore"] = None,
        text_only_suffix: bool = False,
        min_free_ram_bytes: int = 1 << 30,
        exact_disk_store: Optional["ExactDiskStore"] = None,
    ):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.media_token_ids = tuple(media_token_ids)
        self.blocks: Dict[str, APCBlock] = {}
        self.disk = disk_store
        self.exact_disk = exact_disk_store
        self.text_only_suffix = text_only_suffix
        self.min_free_ram_bytes = min_free_ram_bytes
        self.lock = threading.RLock()
        self.stats = APCStats()
        # key -> (token_len, snapshot, capacity)
        self._exact: Dict[str, Tuple[int, Any, Optional[int]]] = {}

    # ----------------------------------------------------------------- query
    def lookup(self, tokens: Sequence[int], extra: str = "") -> Tuple[int, List[APCBlock]]:
        """Longest cached prefix (a multiple of block_size, media-safe,
        strictly shorter than the prompt); its blocks stay pinned until
        `release`."""
        bs = self.block_size
        tokens = list(tokens)
        with self.lock:
            self.stats.lookups += 1
            matched: List[APCBlock] = []
            parent = None
            limit = (len(tokens) - 1) // bs  # leave >= 1 token to prefill
            for b in range(limit):
                chunk = tuple(tokens[b * bs : (b + 1) * bs])
                h = _hash(parent, chunk, extra)
                blk = self.blocks.get(h)
                if blk is None and self.disk is not None:
                    # promote from the disk tier, guarded by free host RAM
                    if _free_ram_bytes() < self.min_free_ram_bytes:
                        self.stats.reject("low_ram")
                        break
                    blk = self.disk.get(h)
                    if blk is not None:
                        self._evict_if_full()
                        self.blocks[h] = blk
                if blk is None:
                    break
                matched.append(blk)
                parent = h
            prefix = len(matched) * bs
            safe = adjust_prefix_to_media_boundary(
                prefix, tokens, self.media_token_ids
            )
            if safe != prefix:
                self.stats.reject("media_boundary")
                safe = (safe // bs) * bs
                matched = matched[: safe // bs]
                prefix = safe
            if (self.text_only_suffix and prefix
                    and not prefix_leaves_text_only_suffix(
                        tokens, prefix, self.media_token_ids)):
                self.stats.reject("media_suffix")
                matched = []
                prefix = 0
            now = time.time()
            for blk in matched:
                blk.last_used = now
                blk.refs += 1  # pinned until release(): eviction skips it
            if prefix:
                self.stats.hits += 1
                self.stats.hit_tokens += prefix
            return prefix, matched

    def release(self, blocks: List[APCBlock]):
        """Unpin the blocks that lookup() returned."""
        with self.lock:
            for blk in blocks:
                blk.refs = max(0, blk.refs - 1)

    # ----------------------------------------------------------------- store
    def commit(
        self,
        tokens: Sequence[int],
        cache,
        extra: str = "",
        row: int = 0,
        upto: Optional[int] = None,
    ):
        """Cut the prompt's K/V into blocks and insert those not cached yet.
        `cache` is a `KVCache` / `BatchKVCache`; its rows of the missing
        blocks are copied to the host once, here, and the copy is waited
        for."""
        bs = self.block_size
        tokens = list(tokens)
        n = upto if upto is not None else len(tokens)
        n = (n // bs) * bs
        if n == 0:
            self.stats.reject("too_short")
            return 0
        if type(cache).__name__ not in ("KVCache", "BatchKVCache"):
            self.stats.reject("cache_type")
            return 0
        # the hash chain first; the copy covers only the missing suffix
        hashes = []
        parent = None
        for b in range(n // bs):
            chunk = tuple(tokens[b * bs : (b + 1) * bs])
            h = _hash(parent, chunk, extra)
            hashes.append((h, parent, chunk))
            parent = h
        with self.lock:
            first_missing = next(
                (i for i, (h, _, _) in enumerate(hashes) if h not in self.blocks),
                None,
            )
        if first_missing is None:
            return 0
        lo = first_missing * bs
        k_host = _host(cache.k[:, row, :, lo:n, :])  # [L, H, n - lo, D]
        v_host = _host(cache.v[:, row, :, lo:n, :])
        stored = 0
        with self.lock:
            for b in range(first_missing, n // bs):
                h, parent, chunk = hashes[b]
                if h not in self.blocks:
                    self._evict_if_full()
                    s = (b * bs) - lo
                    blk = APCBlock(
                        hash=h,
                        parent=parent,
                        tokens=chunk,
                        k=k_host[:, :, s : s + bs, :].copy(),
                        v=v_host[:, :, s : s + bs, :].copy(),
                        last_used=time.time(),
                    )
                    self.blocks[h] = blk
                    if self.disk is not None:
                        self.disk.put(blk)
                    stored += 1
            self.stats.stores += stored
        return stored

    def _evict_if_full(self):
        if len(self.blocks) < self.num_blocks:
            return
        # LRU, but never a pinned block, and a parent only once no leaf
        # is left to evict
        parents = {b.parent for b in self.blocks.values() if b.parent}
        free = [b for b in self.blocks.values() if b.refs == 0]
        candidates = [b for b in free if b.hash not in parents] or free
        if not candidates:  # everything pinned: allow over-fill
            return
        victim = min(candidates, key=lambda b: b.last_used)
        del self.blocks[victim.hash]
        self.stats.evictions += 1

    # ------------------------------------------------------------- warm cache
    def make_warm_cache(
        self,
        matched: List[APCBlock],
        model,
        capacity: int,
        dtype=torch.bfloat16,
    ):
        """A fresh one-row cache of `capacity` rows on the model's device
        (generate/ar.py `make_cache`) holding the matched blocks in rows
        [0, prefix), its cursor at the prefix."""
        from .generate.ar import make_cache

        prefix = len(matched) * self.block_size
        dev = torch.device(model.device or "cpu")
        cache = make_cache(model, 1, capacity, dtype, device=dev)
        if not matched:
            return cache
        k_np = np.concatenate([b.k for b in matched], axis=2)  # [L,H,prefix,D]
        v_np = np.concatenate([b.v for b in matched], axis=2)
        cache.k[:, 0, :, :prefix, :] = _device(k_np, cache.k)
        cache.v[:, 0, :, :prefix, :] = _device(v_np, cache.v)
        cache.offset.fill_(prefix)
        return cache

    # ------------------------------------------------------------ exact mode
    def store_exact(self, tokens: Sequence[int], cache, extra: str = "",
                    capacity: Optional[int] = None) -> bool:
        """Keep a host snapshot of `cache` for `tokens`.  The capacity
        recorded is the one its buffers hold (`cache.capacity`); the
        caller's `capacity` stands only for a cache that has none.  The
        reference records the caller's, which its stream_generate computes
        larger than the buffers it allocates."""
        from .core.cache import snapshot

        key = _hash(None, tuple(tokens), "exact:" + extra)
        capacity = getattr(cache, "capacity", capacity)
        snap = snapshot(cache)
        if self.exact_disk is not None:
            try:
                self.exact_disk.put(key, len(tokens), capacity, snap)
            except OSError:
                pass  # best-effort tier
        with self.lock:
            self._exact[key] = (len(tokens), snap, capacity)
            self.stats.stores += 1
            # bound the snapshot count, first in first out
            while len(self._exact) > max(8, self.num_blocks // 256):
                self._exact.pop(next(iter(self._exact)))
                self.stats.evictions += 1
        return True

    def lookup_exact(self, tokens: Sequence[int], extra: str = "",
                     min_prefix_tokens: int = 0,
                     max_prefix_tokens: Optional[int] = None,
                     min_capacity: int = 0, device=None):
        """Longest stored snapshot matching a strict prefix of `tokens`, as
        a cache of fresh tensors on `device` (the card unless the caller
        passes another).  Returns (prefix_len, cache) or (0, None).

        `max_prefix_tokens` is the prefix guard (callers pass len(tokens)
        - guard), `min_prefix_tokens` the media floor, `min_capacity`
        rejects snapshots too small for the continuation (a record without
        a capacity is trusted).  One hash per distinct stored length,
        longest first."""
        from .core.cache import restore

        tokens = list(tokens)
        hi = len(tokens) - 1
        if max_prefix_tokens is not None:
            hi = min(hi, int(max_prefix_tokens))
        with self.lock:
            self.stats.lookups += 1
            store = self._exact
            best = (0, None)
            lengths = sorted({n for n, _, _ in store.values()
                              if min_prefix_tokens <= n <= hi}, reverse=True)
            for n in lengths:
                key = _hash(None, tuple(tokens[:n]), "exact:" + extra)
                hit = store.get(key)
                if hit is not None:
                    if (min_capacity and hit[2] is not None
                            and hit[2] < min_capacity):
                        self.stats.reject("exact_capacity")
                        continue
                    best = (n, hit[1])
                    break
        if best[1] is None and self.exact_disk is not None:
            # the disk leg: scan distinct lengths in the index, load a
            # payload only on a key match, guarded by free host RAM
            if _free_ram_bytes() >= self.min_free_ram_bytes:
                idx = self.exact_disk.lengths()
                by_len = sorted(
                    {n for n, cap in idx.values()
                     if min_prefix_tokens <= n <= hi
                     and not (min_capacity and cap is not None
                              and cap < min_capacity)},
                    reverse=True)
                for n in by_len:
                    key = _hash(None, tuple(tokens[:n]), "exact:" + extra)
                    if key not in idx:
                        continue
                    snap = self.exact_disk.get(key)
                    if snap is not None:
                        with self.lock:
                            # promote for the fast path next time
                            self._exact[key] = (n, snap, idx[key][1])
                        best = (n, snap)
                        break
        if best[1] is None:
            return 0, None
        with self.lock:
            self.stats.hits += 1
            self.stats.hit_tokens += best[0]
        return best[0], restore(best[1], device or "cuda")

    def reset(self):
        with self.lock:
            self.blocks.clear()
            self._exact.clear()

    def snapshot(self) -> dict:
        with self.lock:
            out = {
                "enabled": True,
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "used_blocks": len(self.blocks),
                **self.stats.as_dict(),
            }
            if self.disk is not None:
                out.update(self.disk.stats())
            return out


def from_env(media_token_ids: Sequence[int] = ()) -> Optional[APCManager]:
    """APC_ENABLED / APC_NUM_BLOCKS / APC_BLOCK_SIZE / APC_DISK_PATH (with
    APC_DISK_LAYOUT "sharded" or "blocks", APC_DISK_MAX_BYTES,
    APC_BLOCKS_PER_SHARD, APC_EXACT_DISK_MAX_BYTES) / APC_TEXT_ONLY_SUFFIX
    / APC_MIN_FREE_RAM_BYTES; None unless APC_ENABLED is set."""
    if os.environ.get("APC_ENABLED", "0") not in ("1", "true", "True"):
        return None
    disk = None
    exact_disk = None
    if os.environ.get("APC_DISK_PATH"):
        max_bytes = int(os.environ.get("APC_DISK_MAX_BYTES", 8 * 1024**3))
        if os.environ.get("APC_DISK_LAYOUT", "sharded") == "blocks":
            disk = DiskBlockStore(os.environ["APC_DISK_PATH"], max_bytes)
        else:
            disk = ShardedDiskStore(
                os.environ["APC_DISK_PATH"], max_bytes,
                blocks_per_shard=int(
                    os.environ.get("APC_BLOCKS_PER_SHARD", 256)),
            )
        exact_disk = ExactDiskStore(
            os.path.join(os.environ["APC_DISK_PATH"], "exact"),
            max_bytes=int(os.environ.get("APC_EXACT_DISK_MAX_BYTES",
                                         4 * 1024**3)),
        )
    return APCManager(
        num_blocks=int(os.environ.get("APC_NUM_BLOCKS", DEFAULT_NUM_BLOCKS)),
        block_size=int(os.environ.get("APC_BLOCK_SIZE", DEFAULT_BLOCK_SIZE)),
        media_token_ids=media_token_ids,
        disk_store=disk,
        text_only_suffix=os.environ.get(
            "APC_TEXT_ONLY_SUFFIX", "0") in ("1", "true", "True"),
        min_free_ram_bytes=int(
            os.environ.get("APC_MIN_FREE_RAM_BYTES", 1 << 30)),
        exact_disk_store=exact_disk,
    )

"""Port parity: automatic prefix caching (apc.py, apc_adapters.py, the
snapshots of core/cache.py, and the prompt caches of generate_step and
BatchGenerator).

Host code is held EQUAL to the JAX package's: hashes, the media rules,
stats, eviction and pinning, the blocks (bfloat16 blocks as their bits),
the sharded disk tier's files byte for byte, and the capability of every
cache `make_cache` builds.  The reference's tests/test_apc.py cases run
here on the port, most of them on both packages side by side.  Generation
runs both packages in float32 on the CPU on the same parameters
(`params_from_jax`): a warm prefix gives the greedy tokens of the cold
prompt and of the JAX package's warm run.  Also: the snapshot is a copy
on both sides of a request, and the reference faults that this port
corrects: (a) the capacity an exact snapshot records, (c) a failed disk
write.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu import apc as japc
from mlx_vlm_tpu import apc_adapters as jada
from mlx_vlm_tpu.core import cache as jcache
from mlx_vlm_tpu.generate import batch as jbatch
from mlx_vlm_tpu.utils.testing import make_tiny_qwen2_vl, tiny_qwen2_vl_config
from mlx_vlm_tpu_torch import apc as tapc
from mlx_vlm_tpu_torch import apc_adapters as tada
from mlx_vlm_tpu_torch.core import cache as tcache
from mlx_vlm_tpu_torch.generate import batch as tbatch
from test_torch_batch import KINDS, _env, _port, hd256  # noqa: F401

jar = importlib.import_module("mlx_vlm_tpu.generate.ar")
tar = importlib.import_module("mlx_vlm_tpu_torch.generate.ar")

torch.set_num_threads(2)

L, H, D = 2, 2, 16  # the tiny model's layers, KV heads and head dim


@pytest.fixture(scope="module")
def pair():
    """tests/test_apc.py's model (seed 9, f32) and its port."""
    jm = make_tiny_qwen2_vl(seed=9, dtype=jnp.float32)
    return jm, _port(jm, tiny_qwen2_vl_config())


def _kv(n: int, C: int = 64, seed: int = 0, dtype="float32"):
    """The same filled KVCache in both packages: rows [0, n) random, the
    cursor at n."""
    rng = np.random.default_rng(seed)
    k = np.zeros((L, 1, H, C, D), np.float32)
    v = np.zeros_like(k)
    k[:, :, :, :n] = rng.standard_normal((L, 1, H, n, D))
    v[:, :, :, :n] = rng.standard_normal((L, 1, H, n, D))
    jk, jv = jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype)
    tk = torch.from_numpy(k).to(getattr(torch, dtype))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    j = jcache.KVCache(k=jk, v=jv, offset=jnp.asarray(n, jnp.int32),
                       left_pad=jnp.zeros((1,), jnp.int32))
    t = tcache.KVCache(k=tk, v=tv, offset=torch.tensor(n, dtype=torch.int32),
                       left_pad=torch.zeros((1,), dtype=torch.int32))
    return j, t


def _bits(a) -> bytes:
    """A block array's bytes (a JAX bf16 block as its uint16 bits)."""
    a = np.asarray(a)
    return a.view(np.uint16).tobytes() if a.dtype.itemsize == 2 else a.tobytes()


def _same_pools(jm, tm, atol=None):
    """Equal stats, hashes and pins; blocks byte-equal, or within `atol`
    where each package computed the K/V itself."""
    assert jm.stats.as_dict() == tm.stats.as_dict()
    assert jm.snapshot() == tm.snapshot()
    assert list(jm.blocks) == list(tm.blocks)
    for h, jb in jm.blocks.items():
        tb = tm.blocks[h]
        assert (jb.parent, jb.tokens, jb.refs) == (tb.parent, tb.tokens,
                                                   tb.refs)
        if atol is None:
            assert _bits(jb.k) == _bits(tb.k) and _bits(jb.v) == _bits(tb.v)
        else:
            np.testing.assert_allclose(tb.k, jb.k, rtol=0, atol=atol)
            np.testing.assert_allclose(tb.v, jb.v, rtol=0, atol=atol)
        assert tb.k.dtype == (np.uint16 if jb.k.dtype.itemsize == 2
                              else jb.k.dtype)


# ------------------------------------------------------------ hashes, rules
HASH_CASES = [(None, (1, 2, 3), ""), ("ab" * 32, (7,) * 16, "x"),
              ("p", tuple(range(100, 116)), "exact:salt"), (None, (), "")]


@pytest.mark.parametrize("case", HASH_CASES)
def test_hash_matches_jax(case):
    assert tapc._hash(*case) == japc._hash(*case)


@pytest.mark.parametrize("images", [None, [np.zeros((4, 4))],
                                    [np.ones((2, 3, 5), np.float32),
                                     np.arange(70000, dtype=np.uint8)]])
@pytest.mark.parametrize("model_key,tenant", [("", ""), ("qwen2_vl", "t1")])
def test_semantic_extra_hash_matches_jax(images, model_key, tenant):
    """Equal to the JAX package's salt where each array lies within the
    64 KiB it reads; past that the port reads every byte (a 70,000-byte
    array), so the salts differ and a change in the last byte moves the
    port's salt alone."""
    got = tapc.semantic_extra_hash(model_key, images, tenant)
    ref = japc.semantic_extra_hash(model_key, images, tenant)
    if all(np.asarray(im).nbytes <= 65536 for im in images or []):
        assert got == ref
        return
    assert got != ref
    late = [np.array(im, copy=True) for im in images]
    late[-1].reshape(-1)[-1] ^= 1
    assert tapc.semantic_extra_hash(model_key, late, tenant) != got
    assert japc.semantic_extra_hash(model_key, late, tenant) == ref


MEDIA_CASES = [([1, 5, 5, 2, 5, 3], [5]), ([1, 5, 5, 5, 2], [5]),
               (list(range(100, 110)) + [7] * 4 + [110, 111], [7]),
               ([9, 9, 1, 2], [9]), ([1, 2, 3], [])]


@pytest.mark.parametrize("tokens,media", MEDIA_CASES)
def test_media_rules_match_jax(tokens, media):
    assert (tapc.media_token_spans(tokens, media)
            == japc.media_token_spans(tokens, media))
    assert (tapc.media_safe_prefix_min(tokens, media)
            == japc.media_safe_prefix_min(tokens, media))
    for p in range(len(tokens) + 1):
        assert (tapc.adjust_prefix_to_media_boundary(p, tokens, media)
                == japc.adjust_prefix_to_media_boundary(p, tokens, media))
        assert (tapc.prefix_leaves_text_only_suffix(tokens, p, media)
                == japc.prefix_leaves_text_only_suffix(tokens, p, media))


# ------------------------------------------------------------ the pool
def _sequence(mod, cache, kw):
    """One lookup / commit / eviction / pinning sequence on a pool."""
    apc = mod.APCManager(**kw)
    toks = list(range(40))
    apc.commit(toks, cache, upto=24)
    apc.lookup(toks[:13] + [99] * 5)
    p, blocks = apc.lookup(toks)                   # pins what it found
    apc.commit(list(range(200, 240)), cache, extra="img", upto=40)
    apc.commit(toks, cache)                        # the rest of the chain
    apc.lookup(toks, extra="img")
    apc.release(blocks)
    apc.commit(list(range(300, 316)), cache, row=0)
    apc.commit([1, 2], cache)                      # too short
    return apc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(num_blocks=64, block_size=4),
                                dict(num_blocks=5, block_size=4),
                                dict(num_blocks=3, block_size=8),
                                dict(num_blocks=8, block_size=4,
                                     media_token_ids=[12, 13, 14])])
def test_pool_sequence_matches_jax(kw, dtype):
    j, t = _kv(40, dtype=dtype)
    _same_pools(_sequence(japc, j, kw), _sequence(tapc, t, kw))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_commit_and_lookup(pkg):
    """tests/test_apc.py::TestBlockPool::test_commit_and_lookup."""
    mod = japc if pkg == "jax" else tapc
    apc = mod.APCManager(num_blocks=64, block_size=4)
    tokens = list(range(20))
    cache = _kv(20, 32)[pkg == "port"]
    assert apc.commit(tokens, cache) == 5
    prefix, blocks = apc.lookup(tokens)
    assert prefix == 16 and len(blocks) == 4
    assert apc.lookup(tokens, extra="other")[0] == 0
    assert apc.lookup(tokens[:9] + [99, 98, 97])[0] == 8


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_eviction_and_stats(pkg):
    mod = japc if pkg == "jax" else tapc
    apc = mod.APCManager(num_blocks=3, block_size=2)
    cache = _kv(8, 16)[pkg == "port"]
    apc.commit([1, 2, 3, 4], cache)
    apc.commit([9, 10, 11, 12], cache)
    assert len(apc.blocks) == 3 and apc.stats.evictions >= 1
    apc2 = mod.APCManager(num_blocks=8, block_size=2)
    apc2.lookup([1, 2, 3])
    snap = apc2.snapshot()
    assert snap["lookups"] == 1 and snap["enabled"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_pinned_blocks_survive_eviction(pkg):
    """tests/test_apc.py::TestRefCounting, on each package's KVCache."""
    mod = japc if pkg == "jax" else tapc
    apc = mod.APCManager(num_blocks=2, block_size=4)
    cache = _kv(16, 16)[pkg == "port"]
    apc.commit(list(range(8)), cache, upto=8)
    prefix, blocks = apc.lookup(list(range(8)) + [99])
    assert prefix == 8 and all(b.refs == 1 for b in blocks)
    apc.commit(list(range(100, 108)), cache, upto=8)
    assert all(b.hash in apc.blocks for b in blocks)
    apc.release(blocks)
    assert all(b.refs == 0 for b in blocks)
    apc.commit(list(range(200, 208)), cache, upto=8)
    assert len(apc.blocks) <= 5


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_text_only_suffix_rule(pkg):
    mod = japc if pkg == "jax" else tapc
    tokens = list(range(100, 110)) + [7, 7, 7, 7] + [110, 111]
    cache = _kv(16, 32)[pkg == "port"]
    apc = mod.APCManager(num_blocks=64, block_size=4, media_token_ids=[7],
                         text_only_suffix=True)
    apc.commit(tokens, cache)
    assert apc.lookup(tokens) == (0, [])
    assert apc.stats.rejects.get("media_suffix", 0) == 1
    apc2 = mod.APCManager(num_blocks=64, block_size=4, media_token_ids=[7])
    apc2.commit(tokens, cache)
    prefix2, blocks2 = apc2.lookup(tokens)
    assert prefix2 == 8
    apc2.release(blocks2)


def test_commit_rejects_other_caches_and_copies_the_rows():
    """A quantized cache is refused as in the reference; a block is a copy
    (writing the cache afterwards leaves it as it was)."""
    apc = tapc.APCManager(num_blocks=16, block_size=4)
    i4 = tcache.init_int4_cache(L, 1, H, D, 32)
    assert apc.commit(list(range(8)), i4) == 0
    assert apc.stats.rejects == {"cache_type": 1}
    _, t = _kv(8, 32)
    apc.commit(list(range(8)), t)
    before = [(_bits(b.k), _bits(b.v)) for b in apc.blocks.values()]
    t.k.fill_(7.0)
    t.v.fill_(7.0)
    assert [(_bits(b.k), _bits(b.v)) for b in apc.blocks.values()] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_warm_cache_holds_the_blocks(pair, dtype):
    """make_warm_cache: rows [0, prefix) are the blocks' bytes, the rest
    zero, the device cursor at the prefix; at prefix 0 a fresh cache."""
    tm = pair[1]
    _, t = _kv(12, 32, dtype=dtype)
    apc = tapc.APCManager(num_blocks=16, block_size=4)
    apc.commit(list(range(12)), t)
    prefix, blocks = apc.lookup(list(range(13)))
    warm = apc.make_warm_cache(blocks, tm, 64, getattr(torch, dtype))
    assert prefix == 12 and warm.capacity == 64
    assert isinstance(warm.offset, torch.Tensor) and warm.offset.dim() == 0
    assert int(warm.offset) == 12
    assert torch.equal(warm.k[:, :, :, :12], t.k[:, :, :, :12])
    assert torch.equal(warm.v[:, :, :, :12], t.v[:, :, :, :12])
    assert not warm.k[:, :, :, 12:].any()
    cold = apc.make_warm_cache([], tm, 64, torch.float32)
    assert int(cold.offset) == 0 and not cold.k.any()


# ------------------------------------------------------------ disk tiers
def _commit_into(mod, store, caches, block_size=4):
    apc = mod.APCManager(num_blocks=256, block_size=block_size,
                         disk_store=store)
    for toks, cache in caches:
        apc.commit(toks, cache)
    store.flush()
    return apc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_shard", [256, 2])
def test_sharded_files_byte_equal(tmp_path, dtype, per_shard):
    pairs = [_kv(24, 32, seed=s, dtype=dtype) for s in (0, 1)]
    toks = [list(range(24)), list(range(50, 74))]
    out = {}
    for i, (mod, name) in enumerate(((japc, "jax"), (tapc, "port"))):
        store = mod.ShardedDiskStore(str(tmp_path / name), max_bytes=10**9,
                                     blocks_per_shard=per_shard)
        _commit_into(mod, store, [(t, p[i]) for t, p in zip(toks, pairs)])
        out[name] = {f: (tmp_path / name / f).read_bytes()
                     for f in sorted(os.listdir(tmp_path / name))}
    assert list(out["port"]) == list(out["jax"])
    assert out["port"] == out["jax"]
    meta = out["port"]["index.jsonl"].splitlines()[0]
    assert f'"dtype": "{dtype}"'.encode() in meta


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_restart_survival_both_layouts(pkg, tmp_path):
    """tests/test_apc.py's restart survival of both disk layouts."""
    mod = japc if pkg == "jax" else tapc
    tokens = list(range(12))
    j, t = _kv(12, 32)
    cache = t if pkg == "port" else j
    fill = np.asarray(_kv(12, 32)[0].k)[0, 0, 0, :4]
    for make in (lambda p: mod.DiskBlockStore(p, max_bytes=10**9),
                 lambda p: mod.ShardedDiskStore(p, max_bytes=10**9)):
        path = str(tmp_path / f"{pkg}-{len(os.listdir(tmp_path))}")
        disk1 = make(path)
        _commit_into(mod, disk1, [(tokens, cache)])
        assert disk1.stats()["disk_blocks"] == 3
        apc2 = mod.APCManager(num_blocks=64, block_size=4,
                              disk_store=make(path))
        prefix, blocks = apc2.lookup(tokens)
        assert prefix == 8 and apc2.disk.loads >= 2
        assert np.array_equal(np.asarray(blocks[0].k)[0, 0], fill)
        apc2.release(blocks)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_block_files_read_both_ways(writer, tmp_path):
    """A block file of either package loads in the other, and a file the
    port writes loads in safetensors.numpy with equal tensors and
    metadata."""
    from safetensors import safe_open
    from safetensors.numpy import load_file

    tokens = list(range(8))
    j, t = _kv(8, 16, seed=4)
    mod, other = (japc, tapc) if writer == "jax" else (tapc, japc)
    store = mod.DiskBlockStore(str(tmp_path), max_bytes=10**9)
    src = _commit_into(mod, store, [(tokens, j if writer == "jax" else t)])
    reader = other.DiskBlockStore(str(tmp_path), max_bytes=10**9)
    for h, blk in src.blocks.items():
        got = reader.get(h)
        assert got is not None
        assert (got.parent, got.tokens) == (blk.parent, blk.tokens)
        assert _bits(got.k) == _bits(blk.k) and _bits(got.v) == _bits(blk.v)
        f = store._file(h)
        arrs = load_file(f)
        assert np.array_equal(arrs["k"], blk.k)
        with safe_open(f, framework="numpy") as sf:
            assert sf.metadata() == {"parent": blk.parent or "",
                                     "tokens": str(list(blk.tokens))}


def test_bf16_block_file_is_bf16(tmp_path):
    """The port stores a bfloat16 block as BF16 and reads it back."""
    import json
    import struct

    _, t = _kv(4, 8, dtype="bfloat16")
    store = tapc.DiskBlockStore(str(tmp_path), max_bytes=10**9)
    apc = _commit_into(tapc, store, [(list(range(4)), t)])
    (h, blk), = apc.blocks.items()
    with open(store._file(h), "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    assert header["k"]["dtype"] == header["v"]["dtype"] == "BF16"
    got = tapc.DiskBlockStore(str(tmp_path)).get(h)
    assert got.k.dtype == np.uint16 and _bits(got.k) == _bits(blk.k)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_byte_budget_eviction(pkg, tmp_path):
    mod = japc if pkg == "jax" else tapc
    cache = _kv(64, 64)[pkg == "port"]
    one = L * H * 4 * D * 4 * 2
    disk = mod.DiskBlockStore(str(tmp_path / "b"), max_bytes=int(one * 2.5))
    _commit_into(mod, disk, [(list(range(64)), cache)])
    assert disk.stats()["disk_bytes"] <= one * 2.5 + 1024
    sh = mod.ShardedDiskStore(str(tmp_path / "s"), max_bytes=int(one * 6),
                              blocks_per_shard=4)
    _commit_into(mod, sh, [(list(range(64)), cache)])
    st = sh.stats()
    assert st["disk_shards"] >= 1 and st["disk_bytes"] <= one * 10


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_load_prefix_and_index_compaction(pkg, tmp_path):
    mod = japc if pkg == "jax" else tapc
    tokens = list(range(16))
    cache = _kv(32, 32, seed=2)[pkg == "port"]
    disk = mod.ShardedDiskStore(str(tmp_path / "p"), max_bytes=10**9)
    _commit_into(mod, disk, [(tokens, cache)])
    hashes, parent = [], None
    for b in range(4):
        parent = mod._hash(parent, tuple(tokens[b * 4:(b + 1) * 4]), "")
        hashes.append(parent)
    k, v = disk.load_prefix(hashes)
    ref = np.asarray(_kv(32, 32, seed=2)[0].k)[:, 0, :, :16]
    assert k.shape[2] == v.shape[2] == 16 and np.array_equal(k, ref)
    assert disk.load_prefix(hashes[:2] + ["nope"]) is None
    one = L * H * 4 * D * 4 * 2
    small = mod.ShardedDiskStore(str(tmp_path / "c"), max_bytes=int(one * 4),
                                 blocks_per_shard=2)
    _commit_into(mod, small, [(list(range(64)), _kv(64, 64)[pkg == "port"])])
    with open(small._index_file()) as fh:
        lines = [ln for ln in fh if ln.strip()]
    assert len(lines) == len(small._index) + 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_torn_record_truncated_on_next_write(pkg, tmp_path):
    mod = japc if pkg == "jax" else tapc
    disk = mod.ShardedDiskStore(str(tmp_path), max_bytes=10**9)
    apc = _commit_into(mod, disk, [(list(range(8)),
                                    _kv(8, 32)[pkg == "port"])])
    rec = disk._meta["rec_bytes"]
    shard = disk._shard_file(0)
    with open(shard, "ab") as fh:
        fh.write(b"\x7f" * (rec // 2))
    tokens2 = list(range(100, 112))
    apc.commit(tokens2, _kv(12, 32, seed=5)[pkg == "port"])
    disk.flush()
    assert os.path.getsize(shard) % rec == 0
    apc2 = mod.APCManager(num_blocks=64, block_size=4,
                          disk_store=mod.ShardedDiskStore(str(tmp_path)))
    prefix, blocks = apc2.lookup(tokens2)
    assert prefix == 8
    ref = np.asarray(_kv(12, 32, seed=5)[0].k)[:, 0, :, :4]
    assert np.array_equal(np.asarray(blocks[0].k), ref)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_free_ram_guard_rejects_promotion(pkg, tmp_path):
    mod = japc if pkg == "jax" else tapc
    tokens = list(range(12))
    disk = mod.ShardedDiskStore(str(tmp_path), max_bytes=10**9)
    _commit_into(mod, disk, [(tokens, _kv(12, 32)[pkg == "port"])])
    apc2 = mod.APCManager(num_blocks=64, block_size=4, disk_store=disk,
                          min_free_ram_bytes=1 << 60)
    assert apc2.lookup(tokens) == (0, [])
    assert apc2.stats.rejects.get("low_ram", 0) == 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_failed_disk_write_leaves_the_pool_whole(pkg, tmp_path, monkeypatch):
    """Reference fault (c) checked: the disk writers swallow every error
    (apc.py:168-178, :361-371), their best-effort design.  A write that
    fails loses the file only: the RAM pool keeps every block, and a
    lookup still hits."""
    mod = japc if pkg == "jax" else tapc

    def broken(*a, **k):
        raise OSError("disk full")

    if pkg == "jax":
        import safetensors.numpy

        monkeypatch.setattr(safetensors.numpy, "save_file", broken)
    else:
        from mlx_vlm_tpu_torch.utils import loader

        monkeypatch.setattr(loader, "write_safetensors", broken)
    tokens = list(range(12))
    cache = _kv(12, 32)[pkg == "port"]
    for store in (mod.DiskBlockStore(str(tmp_path / "b")),
                  mod.ShardedDiskStore(str(tmp_path / "s"))):
        if isinstance(store, mod.ShardedDiskStore):
            monkeypatch.setattr(store, "_rec_meta", broken)
        apc = _commit_into(mod, store, [(tokens, cache)])
        assert store.writes == 0 and len(apc.blocks) == 3
        assert apc.stats.stores == 3
        prefix, blocks = apc.lookup(tokens)
        assert prefix == 8
        apc.release(blocks)


# ------------------------------------------------------------ exact mode
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_longest_snapshot_wins(pkg):
    mod = japc if pkg == "jax" else tapc
    arr = jnp.asarray if pkg == "jax" else torch.tensor
    apc = mod.APCManager(num_blocks=16, block_size=4)
    apc.store_exact(list(range(4)), {"offset": arr(4)})
    apc.store_exact(list(range(8)), {"offset": arr(8)})
    if pkg == "jax":
        n, cache = apc.lookup_exact(list(range(10)))
    else:
        n, cache = apc.lookup_exact(list(range(10)), device="cpu")
    assert n == 8 and int(cache["offset"]) == 8
    assert apc.lookup_exact([5, 5, 5]) == (0, None)


def _snap(pkg, n):
    j, t = _kv(n, 32)
    return j if pkg == "jax" else t


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_exact_disk_restart_and_capacity_filter(pkg, tmp_path):
    mod = japc if pkg == "jax" else tapc
    kw = {} if pkg == "jax" else {"device": "cpu"}
    tokens = list(range(12))
    apc1 = mod.APCManager(num_blocks=8, block_size=4,
                          exact_disk_store=mod.ExactDiskStore(
                              str(tmp_path / "e"), max_bytes=10**9))
    apc1.store_exact(tokens, _snap(pkg, 12), capacity=32)
    apc2 = mod.APCManager(num_blocks=8, block_size=4,
                          exact_disk_store=mod.ExactDiskStore(
                              str(tmp_path / "e"), max_bytes=10**9))
    n, cache = apc2.lookup_exact(tokens + [99, 98], **kw)
    assert n == 12 and int(cache.offset) == 12
    assert np.array_equal(np.asarray(cache.k), np.asarray(_snap("jax", 12).k))
    apc2.exact_disk = None
    assert apc2.lookup_exact(tokens + [99, 98], **kw)[0] == 12
    disk = mod.ExactDiskStore(str(tmp_path / "f"), max_bytes=10**9)
    apc = mod.APCManager(num_blocks=8, block_size=4, exact_disk_store=disk)
    apc.store_exact(list(range(8)), _snap(pkg, 8), capacity=32)
    apc._exact.clear()
    assert apc.lookup_exact(list(range(10)), min_capacity=64, **kw)[0] == 0


def test_exact_disk_byte_budget_and_unlocked_write(tmp_path, monkeypatch):
    """The port's ExactDiskStore evicts the oldest under its budget, as the
    reference's does, and writes the payload without its lock held."""
    snap = tcache.snapshot(_snap("port", 4))
    one = sum(t.numel() * t.element_size() for t in (snap.k, snap.v))
    disk = tapc.ExactDiskStore(str(tmp_path), max_bytes=int(one * 2.5))
    import pickle

    held = []
    real = pickle.dump

    def spy(*a, **k):
        held.append(disk.lock.locked())
        return real(*a, **k)

    monkeypatch.setattr(pickle, "dump", spy)
    for i in range(4):
        disk.put(f"k{i}", 8, 32, snap)
    assert held and not any(held)
    pkls = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    assert len(pkls) <= 3 and not any(f.endswith(".tmp")
                                      for f in os.listdir(tmp_path))


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "rotated-int4",
                                  "affine-4"])
def test_snapshot_round_trip_is_a_copy(hd256, kind):
    """snapshot() and restore() copy every buffer, the cursor and left_pad
    (on the CPU too, where .cpu() would alias): writing the cache after the
    snapshot, or the restored cache, leaves the snapshot as it was."""
    tm = hd256[1]
    kv_bits, env, _ = KINDS[kind]
    with _env(**env):
        cache = tar.make_cache(tm, 1, 256, torch.float32, kv_bits,
                               device="cpu")
    for t in tcache.cache_buffers(cache):
        t.copy_(torch.randint(0, 100, t.shape).to(t.dtype))
    cache.offset.fill_(37)
    snap = tcache.snapshot(cache)
    assert type(snap) is type(cache)
    before = [t.clone() for t in tcache.cache_buffers(snap)]
    for t in tcache.cache_buffers(cache):
        t.zero_()
    cache.offset.fill_(99)
    got = tcache.restore(snap, "cpu")
    for t in tcache.cache_buffers(got):
        t.add_(1)
    got.offset.fill_(5)
    assert all(torch.equal(a, b)
               for a, b in zip(tcache.cache_buffers(snap), before))
    assert int(snap.offset) == 37 and snap.capacity == 256


# ------------------------------------------------------------ adapters
@pytest.mark.parametrize("kv_bits,env", [
    (None, {}), (8, {}), (4, {}), (4, {"MLX_VLM_TPU_KV_SCHEME": "turboquant"}),
    (4, {"MLX_VLM_TPU_KV_SCHEME": "affine"}), (2, {}), (3.5, {}),
    (3.5, {"MLX_VLM_TPU_TQ_SCHEME": "split"})])
def test_capability_of_every_cache_matches_jax(hd256, kv_bits, env):
    jm, tm = hd256
    with _env(**env):
        jc = jar.make_cache(jm, 1, 256, jnp.float32, kv_bits)
        tc = tar.make_cache(tm, 1, 256, torch.float32, kv_bits, device="cpu")
        jada._MODE_CACHE.clear()
        tada._MODE_CACHE.clear()
        jmode = jada.model_apc_mode(jm, kv_bits)
        tmode = tada.model_apc_mode(tm, kv_bits)
    assert tada.cache_capability(tc) == jada.cache_capability(jc)
    assert tmode == jmode
    if kv_bits == 4 and env:
        assert tada.cache_capability(tc) == "exact"


def test_capability_rules_match_jax(pair):
    jm, tm = pair
    jkv, tkv = jar.make_cache(jm, 1, 32, jnp.float32), tar.make_cache(
        tm, 1, 32, torch.float32, device="cpu")
    ji4, ti4 = jcache.init_int4_cache(2, 1, 2, 16, 128), tcache.init_int4_cache(
        2, 1, 2, 16, 128)
    for j, t in ((jkv, tkv), (ji4, ti4), ((jkv, ji4), (tkv, ti4)),
                 ((jkv, object()), (tkv, object())), (object(), object()),
                 (jcache.init_batch_cache(2, 2, 2, 16, 32),
                  tcache.init_batch_cache(2, 2, 2, 16, 32))):
        assert tada.cache_capability(t) == jada.cache_capability(j)

    class Sub(tcache.KVCache):
        pass

    assert tada.cache_capability(Sub(**vars(tkv))) == "exact"


# ------------------------------------------------------------ generation
def _embeds(pkg, model, ids):
    if pkg == "jax":
        return jax.jit(model.get_input_embeddings)(model.params,
                                                   jnp.asarray(ids))
    return model.get_input_embeddings(
        model.params, torch.from_numpy(np.asarray(ids, np.int64)))


def _steps(pkg, model, emb, **kw):
    gen = jar.generate_step if pkg == "jax" else tar.generate_step
    return [int(np.asarray(t).reshape(-1)[0]) for t, _ in gen(emb, model,
                                                               **kw)]


def _warm_vs_cold(pkg, model, S=14, prefix_want=12):
    mod = japc if pkg == "jax" else tapc
    apc = mod.APCManager(num_blocks=64, block_size=4)
    ids = (np.arange(S, dtype=np.int32) * 13 % 200)[None]
    tokens = ids[0].tolist()
    emb = _embeds(pkg, model, ids)
    cold = _steps(pkg, model, emb, max_tokens=6,
                  prompt_cache_callback=lambda c: apc.commit(tokens, c,
                                                             upto=S))
    prefix, blocks = apc.lookup(tokens)
    assert prefix == prefix_want
    dtype = jnp.float32 if pkg == "jax" else torch.float32
    warm_cache = apc.make_warm_cache(blocks, model, 256, dtype)
    assert int(warm_cache.offset) == prefix
    warm = _steps(pkg, model, emb, max_tokens=6, prompt_cache=warm_cache,
                  prefix_len=prefix)
    return cold, warm


def test_warm_prefill_matches_cold_and_jax(pair):
    jcold, jwarm = _warm_vs_cold("jax", pair[0])
    cold, warm = _warm_vs_cold("port", pair[1])
    assert warm == cold == jwarm == jcold


def test_padded_suffix_never_overwrites_the_prefix(pair):
    """A warm cache too small for the suffix's first chunk: the chunk is
    halved until the padded suffix fits behind the prefix (prefix 192 +
    64 rows in 256), and a cache that cannot take it raises before any
    write."""
    tm = pair[1]
    S = 200
    ids = (np.arange(S) * 7 % 200)[None]
    emb = _embeds("port", tm, ids)
    apc = tapc.APCManager(num_blocks=256, block_size=64)
    cold = _steps("port", tm, emb, max_tokens=4, kv_capacity=256,
                  prompt_cache_callback=lambda c: apc.commit(
                      ids[0].tolist(), c, upto=S))
    prefix, blocks = apc.lookup(ids[0].tolist())
    assert prefix == 192
    warm_cache = apc.make_warm_cache(blocks, tm, 256, torch.float32)
    k_prefix = warm_cache.k[:, :, :, :192].clone()
    seen = []
    warm = _steps("port", tm, emb, max_tokens=4, prompt_cache=warm_cache,
                  prefix_len=prefix, prompt_progress_callback=lambda d, n:
                  seen.append((d, n)))
    assert warm == cold and seen == [(S, S)]
    assert torch.equal(tar.last_decode.cache.k[:, :, :, :192], k_prefix)
    tiny = apc.make_warm_cache(blocks, tm, 200, torch.float32)
    with pytest.raises(ValueError, match="too small"):
        next(tar.generate_step(emb, tm, max_tokens=4, prompt_cache=tiny,
                               prefix_len=prefix))


def _batch_warm(pkg, model):
    mod = japc if pkg == "jax" else tapc
    bmod = jbatch if pkg == "jax" else tbatch
    dtype = jnp.float32 if pkg == "jax" else torch.float32
    apc = mod.APCManager(num_blocks=64, block_size=4)
    S = 13
    ids = (np.arange(S, dtype=np.int32) * 3 % 200)[None]
    tokens = ids[0].tolist()
    emb = _embeds(pkg, model, ids)

    def run(warm, capacity=256):
        gen = bmod.BatchGenerator(model, num_slots=2, capacity=256,
                                  block_size=2, dtype=dtype)
        kw = {}
        if warm:
            prefix, blocks = apc.lookup(tokens)
            assert prefix == 12
            kw = dict(prompt_cache=apc.make_warm_cache(blocks, model,
                                                       capacity, dtype),
                      prefix_len=prefix)
        else:
            kw = dict(prompt_cache_callback=lambda c: apc.commit(tokens, c,
                                                                 upto=S))
        gen.insert(bmod.BatchRequest(uid=0, inputs_embeds=emb, max_tokens=6,
                                     **kw))
        out = []
        for _ in range(50):
            if not (gen.num_active or gen.queue):
                break
            for _, toks in gen.next().items():
                out.extend(t for t, _ in toks)
        return out, gen

    cold, _ = run(False)
    warm, gen = run(True)
    # a warm cache too small for its padded suffix falls back to a cold
    # prefill of the whole prompt in a fresh buffer
    small, _ = run(True, capacity=64)
    return cold, warm, small, gen


def test_batch_warm_admission_matches_cold_and_jax(pair):
    jcold, jwarm, jsmall, _ = _batch_warm("jax", pair[0])
    cold, warm, small, gen = _batch_warm("port", pair[1])
    assert warm == cold == jwarm == jcold == small == jsmall
    assert gen.stats["prefill_chunks"] == 1


def test_batched_admission_harvests_a_row_view(pair):
    """Two cold requests admitted together: each harvest gets its own row
    of the batched prefill's cache, cursor at its prompt's length; the
    blocks equal the JAX package's, and a warm rerun of the second prompt
    gives its batched tokens."""
    out = {}
    for pkg, model in zip(("jax", "port"), pair):
        mod = japc if pkg == "jax" else tapc
        bmod = jbatch if pkg == "jax" else tbatch
        dtype = jnp.float32 if pkg == "jax" else torch.float32
        apc = mod.APCManager(num_blocks=64, block_size=4)
        gen = bmod.BatchGenerator(model, num_slots=2, capacity=256,
                                  block_size=2, dtype=dtype)
        prompts = [(np.arange(9) * 5 % 200)[None],
                   (np.arange(14) * 3 % 200)[None]]
        for uid, ids in enumerate(prompts):
            toks = ids[0].tolist()
            gen.insert(bmod.BatchRequest(
                uid=uid, inputs_embeds=_embeds(pkg, model, ids),
                max_tokens=4, prompt_cache_callback=lambda c, t=toks, n=len(
                    toks): apc.commit(t, c, upto=n)))
        got = {0: [], 1: []}
        while gen.num_active or gen.queue:
            for uid, pairs in gen.next().items():
                got[uid].extend(t for t, _ in pairs)
        out[pkg] = (apc, got)
    _same_pools(out["jax"][0], out["port"][0], atol=1e-5)
    assert out["jax"][1] == out["port"][1]
    assert len(out["port"][0].blocks) == 2 + 3


def test_stored_snapshot_is_not_aliased(hd256):
    """Exact mode on the CPU: the stored snapshot keeps its bytes while the
    request that stored it decodes on, and two hits on it give the same
    tokens as the cold prompt."""
    tm = hd256[1]
    apc = tapc.APCManager(num_blocks=64, block_size=4)
    ids = (np.arange(20) * 7 % 200)[None]
    emb = _embeds("port", tm, ids)
    tokens = ids[0].tolist()
    _steps("port", tm, emb[:, :12], max_tokens=8, kv_bits=4,
           prompt_cache_callback=lambda c: apc.store_exact(tokens[:12], c))
    (_, snap, cap), = apc._exact.values()
    before = [t.clone() for t in tcache.cache_buffers(snap)]
    assert int(snap.offset) == 12 and cap == snap.capacity
    live = tar.last_decode.cache
    assert int(live.offset) > 12
    assert all(torch.equal(a, b) for a, b in
               zip(tcache.cache_buffers(snap), before))
    cold = _steps("port", tm, emb, max_tokens=6, kv_bits=4)
    warm = []
    for _ in range(2):
        n, cache = apc.lookup_exact(tokens, max_prefix_tokens=20 - 4,
                                    device="cpu")
        assert n == 12 and int(cache.offset) == 12
        warm.append(_steps("port", tm, emb, max_tokens=6, kv_bits=4,
                           prompt_cache=cache, prefix_len=n))
    assert warm[0] == warm[1] == cold
    assert all(torch.equal(a, b) for a, b in
               zip(tcache.cache_buffers(snap), before))


def test_exact_capacity_records_the_buffers(pair):
    """Reference fault (a): stream_generate records round_up(S + max_tokens
    + block_size + 65, 256) as an exact snapshot's capacity
    (dispatch.py:163, :180-182), while generate_step allocates
    round_up(S + max_tokens + min(block_size, max_tokens) + 1, 256)
    (ar.py:344-351).  At S = 100 and 100 tokens in blocks of 32 the JAX
    package records 512 for buffers of 256 rows, and `lookup_exact` then
    takes that snapshot for a continuation of 200 + 100 tokens that its
    buffers cannot hold.  The port records the buffers' 256 and rejects it
    (exact_capacity)."""
    jm, tm = pair
    S, n, block = 100, 100, 32
    ids = (np.arange(S) * 11 % 200)[None]
    tokens = ids[0].tolist()
    later = tokens + list(range(100))  # 200 tokens, then 100 more
    min_cap = 512  # round_up(200 + 100 + 32 + 65, 256)
    for pkg, model in (("jax", jm), ("port", tm)):
        mod = japc if pkg == "jax" else tapc
        apc = mod.APCManager(num_blocks=64, block_size=16)
        cap = 512  # round_up(S + n + block + 65, 256), as dispatch records
        gen = (jar if pkg == "jax" else tar).generate_step(
            _embeds(pkg, model, ids), model, max_tokens=n, kv_bits=8,
            block_size=block, prompt_cache_callback=lambda c: apc.store_exact(
                tokens, c, capacity=cap))
        next(gen)  # the prefill and its callback
        gen.close()
        (_, snap, recorded), = apc._exact.values()
        buffers = np.asarray(snap.k8).shape[3]
        assert buffers == 256
        kw = {} if pkg == "jax" else {"device": "cpu"}
        hit, _ = apc.lookup_exact(later, max_prefix_tokens=len(later) - 16,
                                  min_capacity=min_cap, **kw)
        if pkg == "jax":  # the divergence: a record past its buffers
            assert recorded == 512 and hit == S
        else:
            assert recorded == 256 and hit == 0
            assert apc.stats.rejects == {"exact_capacity": 1}
    assert n + block + 65 > n + min(block, n) + 1

"""Port parity: the whole-stack fused int4 decode step (K3).

`fused_decode_step_plain` is held to the JAX package's manual-DMA kernel
`fused_decode_step_manual(..., interpret=True)` (its TPU route: z2 math,
fused lm_head) on the same weights and inputs, at the sizes of the JAX
package's own fused-decode tests (hidden 128, intermediate 256, 4/2 heads,
C = 32).  Both run in float32 on the CPU and differ only in the order of
f32 sums (relative 1e-7 to 1e-5).  The first layer's k/v rows, which see
no rounded intermediate yet, agree within 1e-5 * max|ref|.  Every weight
dot rounds x to bf16, so a last-bit difference can flip one element's
rounding (a 2^-9 relative step), and the stack amplifies such flips: h_out,
the later layers' k/v rows and the logits agree within 3e-2 * max|ref| (at
most 1.2e-2 seen over two seeds and three offsets; the JAX package's own
z2-vs-grid test allows atol 0.25 at these sizes), with equal argmax.
Greedy decoding on the port's fused
route is held to the JAX model on its default route (pack attached) with
the bound of the JAX package's `test_fused_matches_unfused_decode`: equal
tokens, logprobs within 0.08 (the JAX CPU route is the grid kernel with
dequant math, the port follows the z2 math).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlx_vlm_tpu.core.quant import quantize, to_int4_grouped
from mlx_vlm_tpu.generate.dispatch import stream_generate as jax_stream
from mlx_vlm_tpu.ops.fused_decode import fused_decode_step_manual
from mlx_vlm_tpu.utils.loader import load_model_from_weights as jax_load
from mlx_vlm_tpu.utils.testing import qwen2_vl_hf_weights, tiny_qwen2_vl_config
from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor
from mlx_vlm_tpu_torch.generate.dispatch import stream_generate
from mlx_vlm_tpu_torch.models.qwen2_vl import Model, ModelConfig
from mlx_vlm_tpu_torch.models.qwen2_vl import language as language_mod
from mlx_vlm_tpu_torch.ops import fused_decode as fd
from mlx_vlm_tpu_torch.utils.loader import decide_fused_decode, params_from_jax
from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

torch.set_num_threads(2)

EXACT, ROUNDED = 1e-5, 3e-2  # relative to max|ref|, see the docstring
C = 32


def _config(layers=2):
    """The JAX package's fused-head test model (tests/test_fused_decode.py
    `_tiny_int4_head_model`)."""
    cfg = tiny_qwen2_vl_config()
    cfg["hidden_size"] = 128
    cfg["intermediate_size"] = 256
    cfg["num_attention_heads"] = 4
    cfg["num_key_value_heads"] = 2
    cfg["num_hidden_layers"] = layers
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
    cfg["vision_config"]["hidden_size"] = 32
    cfg["tie_word_embeddings"] = False
    return cfg


def _weights(cfg, seed):
    weights = qwen2_vl_hf_weights(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in list(weights):
        if ((k.startswith("model.layers.") and k.endswith(".weight")
             and "layernorm" not in k and weights[k].ndim == 2)
                or k == "lm_head.weight"):
            w = rng.standard_normal(weights[k].shape).astype(np.float32) * 0.1
            weights[k] = to_int4_grouped(quantize(jnp.asarray(w), bits=4,
                                                  group_size=64))
    return weights


def _models(layers, seed, **env):
    """(JAX model on its default route, port model from the same params)."""
    cfg = _config(layers)
    mp = pytest.MonkeyPatch()
    for k, v in env.items():
        mp.setenv(k, v)
    try:
        jm = jax_load(dict(cfg), _weights(cfg, seed), jnp.float32)
    finally:
        mp.undo()
    tm = Model(ModelConfig.from_dict(cfg))
    tm.params = params_from_jax(tm, jax.tree_util.tree_map(np.asarray,
                                                           jm.params))
    tm.config_dict = cfg
    tm.device = torch.device("cpu")
    return jm, tm, cfg


@pytest.fixture(scope="module")
def models():
    jm, tm, cfg = _models(2, seed=13)
    pack = jm.params["language_model"]["fused_decode"]
    assert pack.hd_qp is not None and "layers" not in \
        jm.params["language_model"]["model"]
    assert decide_fused_decode(tm)
    return jm, tm, cfg


def _step_inputs(pack, offset, seed=2):
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((1, 1, pack.dim)) * 0.3).astype(np.float32)
    cos = (rng.standard_normal(hd // 2) * 0.1 + 1.0).astype(np.float32)
    sin = (rng.standard_normal(hd // 2) * 0.1).astype(np.float32)
    k = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    v = (rng.standard_normal((L, 1, Hkv, C, hd)) * 0.2).astype(np.float32)
    return h, cos, sin, k, v


def _port_step(tm, h, cos, sin, k, v, offset):
    lm = tm.language_model
    t = [torch.from_numpy(a.copy()) for a in (h, cos, sin, k, v)]
    return fd.fused_decode_step(tm.params["language_model"], lm.args, *t,
                                offset)


@pytest.mark.parametrize("offset", [0, 5, 31])
def test_plain_step_matches_manual_kernel(models, offset):
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    h, cos, sin, k, v = _step_inputs(pack, offset)
    hj, kj, vj, lj = fused_decode_step_manual(
        pack, *(jnp.asarray(a) for a in (h, cos, sin, k, v)),
        jnp.asarray(offset, jnp.int32), interpret=True)
    L, Hkv = pack.n_layers, pack.n_kv
    ht, kt, vt, lt = _port_step(tm, h, cos, sin, k, v, offset)
    assert ht.shape == (1, 1, pack.dim) and ht.dtype == torch.float32
    assert kt.shape == (L, Hkv * pack.head_dim) and lt.shape == (1, pack.head_n)
    kj = np.asarray(kj)[:, :Hkv].reshape(L, -1)
    vj = np.asarray(vj)[:, :Hkv].reshape(L, -1)

    def close(got, ref, rel):
        err = float(np.abs(got - ref).max())
        assert err <= rel * float(np.abs(ref).max()), (err, rel)

    close(kt.numpy()[0], kj[0], EXACT)
    close(vt.numpy()[0], vj[0], EXACT)
    close(kt.numpy()[1:], kj[1:], ROUNDED)
    close(vt.numpy()[1:], vj[1:], ROUNDED)
    close(ht.numpy(), np.asarray(hj), ROUNDED)
    close(lt.numpy(), np.asarray(lj), ROUNDED)
    assert int(lt.argmax()) == int(np.argmax(lj))


def test_step_ignores_rows_past_offset_and_writes_its_row(models):
    """Garbage past `offset` leaves every output unchanged; the step's own
    k/v rows land at `offset` and the rows after it stay as they were."""
    jm, tm, _ = models
    pack = jm.params["language_model"]["fused_decode"]
    offset = 9
    h, cos, sin, k, v = _step_inputs(pack, offset, seed=4)
    L, Hkv, hd = pack.n_layers, pack.n_kv, pack.head_dim
    kg, vg = k.copy(), v.copy()
    kg[:, :, :, offset:] = 1e3
    vg[:, :, :, offset:] = -1e3
    tk, tv = torch.from_numpy(kg), torch.from_numpy(vg)
    ref = _port_step(tm, h, cos, sin, k, v, offset)
    got = fd.fused_decode_step(
        tm.params["language_model"], tm.language_model.args,
        *(torch.from_numpy(a) for a in (h, cos, sin)), tk, tv, offset)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert torch.equal(tk[:, 0, :, offset], got[1].view(L, Hkv, hd))
    assert torch.equal(tv[:, 0, :, offset], got[2].view(L, Hkv, hd))
    assert bool((tk[:, :, :, offset + 1:] == 1e3).all())
    assert bool((tv[:, :, :, offset + 1:] == -1e3).all())


def test_params_from_pack_equal_keep_layers_load():
    """A pack-only JAX tree (the default) gives the port the same stacked
    per-linear tensors, bit for bit, as a MLX_VLM_TPU_KEEP_LAYERS=1 load,
    which keeps the per-linear copies beside the pack."""
    _, packed, _ = _models(3, seed=5)
    jm, kept, _ = _models(3, seed=5, MLX_VLM_TPU_KEEP_LAYERS="1")
    lp = jm.params["language_model"]
    assert "fused_decode" in lp and "layers" in lp["model"]
    a = packed.params["language_model"]["model"]["layers"]
    b = kept.params["language_model"]["model"]["layers"]
    assert "fused_decode" not in packed.params["language_model"]

    def walk(x, y, path):
        if isinstance(x, dict):
            assert sorted(x) == sorted(y), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, Int4GroupedTensor):
            assert (x.n, x.group_size, x.out_dtype) == (
                y.n, y.group_size, y.out_dtype), path
            for f in ("qp", "sl", "sh", "bl", "bh"):
                u, w = getattr(x, f), getattr(y, f)
                assert u.dtype == w.dtype and torch.equal(u, w), f"{path}.{f}"
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), path

    walk(a, b, "layers")


def _greedy(model, stream, n=6):
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 256, 21)]
    res = list(stream(model, ByteTokenizer(), prompt, max_tokens=n,
                      prefill_step_size=64))
    return [r.token for r in res], np.array(
        [float(np.asarray(r.logprobs).reshape(-1)[0]) for r in res])


def test_greedy_generate_on_fused_route_matches_jax_default_route(
        models, monkeypatch):
    jm, tm, _ = models
    calls = []
    step = language_mod.fused_decode_step
    monkeypatch.setattr(language_mod, "fused_decode_step",
                        lambda *a: calls.append(1) or step(*a))
    before = dict(fd.launches)
    jt, jl = _greedy(jm, jax_stream)
    tt, tl = _greedy(tm, stream_generate)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=0.08)
    assert len(calls) == len(tt) - 1  # every decode step took the route
    assert fd.launches == before      # CPU tensors never launch the kernel


def _route_calls(tm, B, S, monkeypatch):
    calls = []
    step = language_mod.fused_decode_step
    monkeypatch.setattr(language_mod, "fused_decode_step",
                        lambda *a: calls.append(1) or step(*a))
    lm = tm.language_model
    lp = tm.params["language_model"]
    cache = lm.init_cache(B, C, torch.float32)
    emb = lm.embed(lp, torch.arange(B * S).view(B, S) % 250)
    pos = torch.arange(S).view(1, 1, S).expand(3, B, S)
    logits = lm.step_logits(lp, emb, cache, pos)
    assert logits.shape == (B, S, 256) and cache.offset == S
    assert bool(torch.isfinite(logits).all())
    return len(calls)


@pytest.mark.parametrize("B,S,route", [(1, 1, True), (1, 4, False),
                                       (2, 1, False)])
def test_route_takes_fused_branch_only_for_one_token(models, monkeypatch, B,
                                                     S, route):
    _, tm, _ = models
    before = dict(fd.launches)
    assert _route_calls(tm, B, S, monkeypatch) == int(route)
    assert fd.launches == before


def test_route_switch_off(monkeypatch):
    jm, tm, _ = _models(2, seed=13, MLX_VLM_TPU_FUSED_DECODE="0")
    assert "fused_decode" not in jm.params["language_model"]
    monkeypatch.setenv("MLX_VLM_TPU_FUSED_DECODE", "0")
    assert not decide_fused_decode(tm)
    assert _route_calls(tm, 1, 1, monkeypatch) == 0
    monkeypatch.setenv("MLX_VLM_TPU_FUSED_DECODE", "1")
    assert decide_fused_decode(tm)


def test_route_rule_takes_the_kernels_limits_on_the_card(models):
    """On the card the fused route needs what K3 takes (head_dim 128 among
    others), as the reference builds no pack on its device otherwise; on
    the CPU the rule stays the reference's.  This model has head_dim 32:
    eligible on the CPU, per-linear on the card."""
    _, tm, cfg = models
    lp, args = tm.params["language_model"], tm.language_model.args
    assert args.hidden_size // args.num_attention_heads == 32
    assert fd.fused_decode_eligible(lp, args, torch.device("cpu"))
    assert not fd.fused_decode_eligible(lp, args, torch.device("cuda"))
    assert fd.kernel_refusal(args, 64, cfg["intermediate_size"])
    try:
        tm.device = torch.device("cuda")
        assert not decide_fused_decode(tm)
    finally:
        tm.device = torch.device("cpu")
        assert decide_fused_decode(tm)
    # a head_dim-128 model within the kernel's limits keeps the route
    wide = dataclasses.replace(args, hidden_size=256, num_attention_heads=2,
                               num_key_value_heads=1)
    assert fd.kernel_refusal(wide, 64, 256) is None
    for bad in (dict(num_key_value_heads=2, num_attention_heads=1),
                dict(hidden_size=2304, num_attention_heads=18,
                     num_key_value_heads=2)):
        assert fd.kernel_refusal(dataclasses.replace(wide, **bad), 64, 256)
    assert fd.kernel_refusal(wide, 24, 256) and fd.kernel_refusal(wide, 64, 192)


def test_step_logits_match_per_linear_path(models):
    """The fused step and the per-linear path on one token: same cache
    cursor and rows, logits within the z2-vs-dequant rounding."""
    _, tm, _ = models
    lm = tm.language_model
    lp = tm.params["language_model"]
    emb = lm.embed(lp, torch.tensor([[7]]))
    pos = torch.full((3, 1, 1), 3)
    out = []
    for fused in (True, False):
        lm.fused_decode = fused
        cache = lm.init_cache(1, C, torch.float32)
        cache.offset = 3
        out.append((lm.step_logits(lp, emb, cache, pos), cache))
    lm.fused_decode = True
    (lf, cf), (lr, cr) = out
    assert cf.offset == cr.offset == 4
    np.testing.assert_allclose(cf.k.numpy(), cr.k.numpy(), atol=0.05)
    np.testing.assert_allclose(lf.numpy(), lr.float().numpy(), atol=0.08)


# ----------------------------------------------------------- on a GPU only


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 100, 300])
def test_cuda_fused_decode_matches_plain(cuda_device, offset):
    """K3 against its plain version on the card at head_dim 128 (bf16
    model, garbage past `offset`).  The first layer's k/v rows agree within
    1e-4 * max|ref| (summation order only); the other outputs within
    6e-2 * max|ref|: the kernel also rounds attention probabilities to bf16
    against a running maximum, and a last-bit difference can flip a bf16
    rounding of x before a weight dot, which the layers amplify."""
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                                 tiny_qwen2_vl_config)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tiny_qwen2_vl_config(hidden_size=512, intermediate_size=1024,
                               num_attention_heads=4, num_key_value_heads=2,
                               num_hidden_layers=2, vocab_size=1024)
    cfg["rope_scaling"] = {"type": "mrope", "mrope_section": [16, 24, 24]}
    cfg, w = mlx_int4_checkpoint(cfg, seed=3)
    model = load_model_from_weights(cfg, w, torch.bfloat16, "cuda")
    lm = model.language_model
    lp = model.params["language_model"]
    assert lm.fused_decode and fd.fused_head(lp, lm.args) is not None
    g = torch.Generator().manual_seed(0)
    cache = lm.init_cache(1, 512, torch.bfloat16, device=cuda_device)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g))
    cache.k[:, :, :, offset:] = 1e3
    cache.v[:, :, :, offset:] = 1e3
    h = torch.randn((1, 1, 512), generator=g).to(cuda_device, torch.bfloat16)
    cos, sin = lm.rope.cos_sin(torch.full((3, 1, 1), offset,
                                          device=cuda_device))
    kc, vc = cache.k.clone(), cache.v.clone()
    n0 = fd.launches["fused_decode"]
    got = fd.fused_decode_step(lp, lm.args, h, cos[0, 0], sin[0, 0], cache.k,
                               cache.v, offset)
    ref = fd.fused_decode_step_plain(lp, lm.args, h, cos[0, 0], sin[0, 0],
                                     kc, vc, offset)
    torch.cuda.synchronize()
    assert fd.launches["fused_decode"] == n0 + 1 and len(got) == 4
    pairs = [(got[1][0], ref[1][0], 1e-4), (got[2][0], ref[2][0], 1e-4),
             (got[0], ref[0], 6e-2), (got[1][1:], ref[1][1:], 6e-2),
             (got[2][1:], ref[2][1:], 6e-2), (got[3], ref[3], 6e-2),
             (cache.k[:, :, :, offset].float(), kc[:, :, :, offset].float(),
              6e-2)]
    for a, b, rel in pairs:
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert bool((cache.k[:, :, :, offset + 1:] == 1e3).all())
    assert bool((cache.v[:, :, :, offset + 1:] == 1e3).all())

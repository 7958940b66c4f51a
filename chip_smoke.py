"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: card, power limit, versions; builds the CUDA kernels from
     mlx_vlm_tpu_torch/csrc with nvcc;
  2. each kernel (K1 int4_matmul, K2 int4_matvec, K4 flash_attention)
     against its plain PyTorch version on the card at Qwen2-VL-7B shapes;
  3. the slice on the card (bf16, kernels) against the slice on the CPU
     (f32, plain versions) at 7B widths with 2 decoder layers, teacher-forced;
  4. the main path at full Qwen2-VL-7B width (random mlx-format 4-bit
     weights, 28 decoder layers, 32 vision blocks): three greedy requests
     through load_model_from_weights and stream_generate, with the kernels'
     launch counters reset before and read after.
The line before the last is the kernel report, the last line the result.
Needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _events_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of an eager fn() call in ms from CUDA events around a loop:
    includes the host's launch overhead whenever the host is the slower."""
    for _ in range(3):
        fn()
    return _events_ms(fn, iters)


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms: fn is captured once in a CUDA graph
    and the graph is replayed between CUDA events, so no host work is
    timed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ms = _events_ms(graph.replay, iters)
    del graph
    return ms


# ------------------------------------------------------------ phase 1


def phase_environment() -> None:
    import torch

    from mlx_vlm_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"driver {driver} nvcc: {nvcc} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    print(f"kernels built and loaded in {build_s:.2f} s "
          f"({_cuda.library_path().name})", flush=True)


# ------------------------------------------------------------ phase 2

K1_SHAPES = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
K2_SHAPES = K1_SHAPES + ((3584, 152064),)


def random_int4(K: int, N: int, gen, device) -> "object":
    """Random halves-packed int4 weight whose dequantized values have std
    ~0.02 (codes uniform in [0, 16), zero-centred by the bias)."""
    import torch

    from mlx_vlm_tpu_torch.core.quant import Int4GroupedTensor, _int4_half_width

    n2p = _int4_half_width(N)
    G = K // 64
    qp = torch.randint(0, 256, (K, n2p), generator=gen, dtype=torch.uint8,
                       device="cpu").to(device)
    planes = []
    for _ in range(2):
        s = (0.02 / 4.6) * (0.5 + torch.rand((G, 1, n2p), generator=gen))
        planes += [s, -7.5 * s]
    sl, bl, sh, bh = (p.to(device) for p in planes)
    return Int4GroupedTensor(qp=qp, sl=sl, sh=sh, bl=bl, bh=bh, n=N,
                             group_size=64, out_dtype="bfloat16")


def _check(results: list, name: str, shape: str, out, ref, rel_tol: float,
           kernel, plain, floor: float = 1.0) -> None:
    """Record max|out - ref| against rel_tol * max(floor, max|ref|) and time
    the kernel and its plain version: device time (graph replay) and eager
    call time."""
    import torch

    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = rel_tol * max(floor, float(ref.float().abs().max()))
    ok = err <= tol
    ms, plain_ms = device_ms(kernel), device_ms(plain, iters=5)
    call = call_ms(kernel)
    print(f"  {name} {shape}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (device time) "
          f"kernel_call_ms={call:.4f} (eager, host included) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    results.append({"name": name, "shape": shape, "err": err, "tol": tol,
                    "ms": ms, "plain_ms": plain_ms, "call_ms": call, "ok": ok})


def phase_kernels() -> list:
    """Each kernel against its plain version on the card at 7B shapes."""
    import torch

    from mlx_vlm_tpu_torch.ops import flash_attention as fa
    from mlx_vlm_tpu_torch.ops import int4_matvec as iv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    results: list = []
    print("phase 2: kernels vs plain versions (tolerances: K1 "
          "2e-2*max(1,|ref|) and K4 2e-2*max|ref| for bf16 output rounding, "
          "K2 1e-3*max(1,|ref|) for summation order)", flush=True)
    weights = {}
    for K, N in K2_SHAPES:
        weights[(K, N)] = random_int4(K, N, gen, dev)
    for K, N in K1_SHAPES:
        t = weights[(K, N)]
        x = torch.randn((512, K), generator=gen).to(dev, torch.bfloat16)
        _check(results, "int4_matmul", f"M=512 K={K} N={N}",
               iv.int4_matmul(x, t), iv.int4_matmul_plain(x, t), 2e-2,
               lambda: iv.int4_matmul(x, t), lambda: iv.int4_matmul_plain(x, t))
    for K, N in K2_SHAPES:
        t = weights[(K, N)]
        x = torch.randn((1, K), generator=gen).to(dev, torch.bfloat16)
        _check(results, "int4_matvec", f"M=1 K={K} N={N}",
               iv.int4_matvec_rows(x, t), iv.int4_matvec_plain(x, t), 1e-3,
               lambda: iv.int4_matvec_rows(x, t),
               lambda: iv.int4_matvec_plain(x, t))
    del weights
    B, H, KVH, D, S, C = 1, 28, 4, 128, 512, 8192
    q1 = torch.randn((B, H, S, D), generator=gen)
    k = torch.randn((B, KVH, C, D), generator=gen).to(dev, torch.bfloat16)
    v = torch.randn((B, KVH, C, D), generator=gen).to(dev, torch.bfloat16)
    off = torch.full((B,), 7680, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    # q_scale 4 sharpens the scores (std 4), so that a cache column masked
    # wrongly (left_pad, window) moves the output far past the tolerance;
    # every row sees at least one key here (offset 7680 > left_pad)
    for lp_val, window, q_scale in ((0, None, 1), (100, None, 4),
                                    (100, 1024, 4)):
        q = (q1 * q_scale).to(dev, torch.bfloat16)
        lp = torch.full((B,), lp_val, dtype=torch.int32, device=dev)
        _check(results, "flash_attention",
               f"B=1 H=28 KVH=4 D=128 S=512 C=8192 offset=7680 "
               f"left_pad={lp_val} window={window} q_scale={q_scale}",
               fa.flash_attention(q, k, v, off, lp, scale, window),
               fa.flash_attention_plain(q, k, v, off, lp, scale, window), 2e-2,
               lambda: fa.flash_attention(q, k, v, off, lp, scale, window),
               lambda: fa.flash_attention_plain(q, k, v, off, lp, scale,
                                                window), floor=0.0)
    return results


# ------------------------------------------------------------ phase 3


def _processor():
    from mlx_vlm_tpu_torch.utils.processing import (Qwen2VLImageProcessor,
                                                    Qwen2VLProcessor)
    from mlx_vlm_tpu_torch.utils.testing import ByteTokenizer

    return Qwen2VLProcessor(ByteTokenizer(), Qwen2VLImageProcessor())


def _image(size: int) -> np.ndarray:
    return np.random.default_rng(SEED + size).integers(
        0, 256, (size, size, 3), dtype=np.uint8)


def teacher_forced_logits(model, inputs: dict, forced=None,
                          n_steps: int = 8) -> tuple:
    """Per-step last-token logits [n_steps, V] (f32 numpy): the prompt in one
    prefill chunk, then n_steps - 1 decode steps fed `forced` tokens, or the
    greedy argmax when `forced` is None."""
    import torch

    dev = model.device
    lm = model.language_model
    lp = model.params["language_model"]
    ids = torch.from_numpy(inputs["input_ids"].astype(np.int64)).to(dev)
    aux = model.vision_aux_inputs(inputs["image_grid_thw"])
    embeds = model.get_input_embeddings(
        model.params, ids, torch.from_numpy(inputs["pixel_values"]).to(dev),
        rotary_freqs=torch.from_numpy(aux["rotary_freqs"]).to(dev),
        segment_ids=torch.from_numpy(aux["segment_ids"]).to(dev))
    pos, deltas = model.prepare_position_ids(
        inputs["input_ids"], inputs["image_grid_thw"])
    S = ids.shape[1]
    cache = lm.init_cache(1, 256 * ((S + n_steps + 255) // 256), embeds.dtype,
                          device=dev)
    h = lm(lp, embeds, cache, torch.from_numpy(pos.astype(np.int64)).to(dev))
    out = [lm.logits(lp, h[:, -1:])[0, 0].float().cpu().numpy()]
    toks = []
    for s in range(n_steps - 1):
        tok = int(np.argmax(out[-1])) if forced is None else forced[s]
        toks.append(tok)
        emb = lm.embed(lp, torch.tensor([[tok]], device=dev))
        p = torch.full((3, 1, 1), cache.offset + int(deltas[0, 0]),
                       dtype=torch.int64, device=dev)
        h = lm(lp, emb, cache, p)
        out.append(lm.logits(lp, h)[0, 0].float().cpu().numpy())
    return np.stack(out), toks


def parity_rule(ref: np.ndarray, got: np.ndarray) -> tuple:
    """bench.py's rule: |got - ref| <= 0.05 * max(1, max|ref|) per step, and
    equal argmax wherever the reference's top-1/top-2 margin exceeds twice
    that bound."""
    tol = 0.05 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin_ok = (top2[:, 1] - top2[:, 0]) > 2 * tol
    same = got.argmax(-1) == ref.argmax(-1)
    ok = err <= tol and bool(np.all(same[margin_ok]))
    return ok, err, tol, int(margin_ok.sum())


def phase_slice_parity() -> bool:
    """The slice on the card (bf16, kernels) vs on the CPU (f32, plain
    versions), 7B widths with 2 decoder layers, same random checkpoint."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.processing import prepare_inputs
    from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                                 qwen2_vl_7b_config)

    print("phase 3: slice on the card (bf16) vs on the CPU (f32), "
          "Qwen2-VL-7B widths, 2 decoder layers, 8 teacher-forced steps",
          flush=True)
    t0 = time.perf_counter()
    cfg = qwen2_vl_7b_config()
    cfg["num_hidden_layers"] = 2
    cfg, weights = mlx_int4_checkpoint(cfg, seed=SEED + 1)
    proc = _processor()
    prompt = apply_chat_template(proc, cfg, "What is in this image?",
                                 num_images=1)
    inputs = prepare_inputs(proc, prompt, images=_image(224))
    cpu = load_model_from_weights(cfg, weights, torch.float32, "cpu")
    ref, toks = teacher_forced_logits(cpu, inputs)
    del cpu
    gpu = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
    got, _ = teacher_forced_logits(gpu, inputs, forced=toks)
    del gpu, weights
    torch.cuda.empty_cache()
    ok, err, tol, n_margin = parity_rule(ref, got)
    print(f"  prompt {inputs['input_ids'].shape[1]} tokens, 8 steps: "
          f"max|cuda - cpu| = {err:.4e}, tol {tol:.4e}; argmax checked on "
          f"{n_margin}/8 steps; {'ok' if ok else 'MISMATCH'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return ok


# ------------------------------------------------------------ phase 4


def phase_main_path() -> dict:
    """Qwen2-VL-7B at full width through the public entry points; returns
    the kernels' launch counts over the three requests."""
    import torch

    from mlx_vlm_tpu_torch import apply_chat_template, stream_generate
    from mlx_vlm_tpu_torch.ops import flash_attention as fa
    from mlx_vlm_tpu_torch.ops import int4_matvec as iv
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.testing import (mlx_int4_checkpoint,
                                                 qwen2_vl_7b_config)

    print("phase 4: main path, Qwen2-VL-7B full width (28 decoder layers, 32 "
          "vision blocks), random mlx 4-bit weights, greedy", flush=True)
    t0 = time.perf_counter()
    cfg, weights = mlx_int4_checkpoint(qwen2_vl_7b_config(), seed=SEED + 2)
    t1 = time.perf_counter()
    model = load_model_from_weights(cfg, weights, torch.bfloat16, "cuda")
    del weights
    t2 = time.perf_counter()
    print(f"  checkpoint built in {t1 - t0:.1f} s, loaded (fold + stack + "
          f"upload) in {t2 - t1:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    proc = _processor()
    long_text = "The quick brown fox jumps over the lazy dog. " * 183
    requests = [
        ("image 448x448 + short prompt", "Describe this image in detail.",
         _image(448), 1, 32),
        ("text only", "Write a short story about a lighthouse.", None, 0, 32),
        ("image + ~8.2k-token prompt", long_text + "Summarize the text and "
         "the image.", _image(448), 1, 16),
    ]
    for counts in (iv.launches, fa.launches):
        for k in counts:
            counts[k] = 0
    for name, text, image, n_img, max_tokens in requests:
        prompt = apply_chat_template(proc, cfg, text, num_images=n_img)
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        times, last = [], None
        for res in stream_generate(model, proc, prompt, image=image,
                                   max_tokens=max_tokens):
            times.append(time.perf_counter())
            if not np.all(np.isfinite(res.logprobs)):
                fail(f"{name}: non-finite logits at token {len(times)}")
            last = res
        if last is None:
            fail(f"{name}: no tokens")
        n = last.generation_tokens
        if not (n == max_tokens or last.finish_reason == "stop"):
            fail(f"{name}: {n} tokens, finish_reason {last.finish_reason}")
        ttft = times[0] - tic
        tps = (n - 1) / (times[-1] - times[0]) if n > 1 else 0.0
        steps_ms = 1e3 * np.diff(times) if n > 1 else np.zeros(1)
        print(f"  {name}: prompt {last.prompt_tokens} tokens, TTFT "
              f"{ttft:.4f} s, decode {tps:.2f} tok/s over {n} tokens (step "
              f"ms min {steps_ms.min():.1f} median {np.median(steps_ms):.1f} "
              f"max {steps_ms.max():.1f}), peak {last.peak_memory:.2f} GiB, "
              f"finish_reason {last.finish_reason}", flush=True)
    launches = {**iv.launches, **fa.launches}
    print(f"  kernel launches on the main path: {launches}", flush=True)
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    return launches


KERNELS = (
    ("int4_matmul", "mlx_vlm_tpu_torch/csrc/int4_matmul.cu",
     "mlx_vlm_tpu/ops/int4_matvec.py:159", "M=512 K=3584 N=18944"),
    ("int4_matvec", "mlx_vlm_tpu_torch/csrc/int4_matvec.cu",
     "mlx_vlm_tpu/ops/int4_matvec.py:223", "M=1 K=3584 N=18944"),
    ("flash_attention", "mlx_vlm_tpu_torch/csrc/flash_attention.cu",
     "mlx_vlm_tpu/ops/flash_attention.py:89",
     "B=1 H=28 KVH=4 D=128 S=512 C=8192 offset=7680 left_pad=0 window=None "
     "q_scale=1"),
)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    phase_environment()
    results = phase_kernels()
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with their plain versions")
    if not phase_slice_parity():
        fail("the slice on the card disagrees with the slice on the CPU")
    launches = phase_main_path()
    report = []
    for name, source, replaces, shape in KERNELS:
        mine = [r for r in results if r["name"] == name]
        at = next(r for r in mine if r["shape"] == shape)
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["err"] for r in mine),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "call_ms": at["call_ms"], "shape": shape})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

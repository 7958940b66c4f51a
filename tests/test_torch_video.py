"""Port parity: video for the Qwen-VL line (Qwen2-VL, Qwen2.5-VL, Qwen3-VL,
Qwen3-VL-MoE) against the JAX package and transformers 4.57.6, on the
CPU at the tiny test sizes, every model loaded in float32 from one
checkpoint on disk per family (build_tiny_checkpoint's trained tokenizer,
patch 14), the clips made from a seed (utils/testing.py
`synthetic_video`: 4 frames of 56 x 84, two frame groups of 4 x 6 patches):

- exactly: the video patches and grid against the JAX package's
  `_preprocess_one`; M-RoPE ids against its `mrope_position_ids`; a
  path read by `load_video` against its; frames given need no cv2;
- the towers' attention within each frame group and window
  (`segment_sdpa`) against the masked `sdpa` they used to run (f32
  summation order only): one call within 1e-5, whole towers within 1e-4
  (the image tests' tolerance against the JAX package), on images and on
  a 4-frame clip;
- the video embeddings within 1e-4 of the JAX package's
  `get_input_embeddings` fed the video patches and
  `vision_aux_inputs(video_grid)`, and teacher-forced logits by bench.py's
  rule and within 1e-3, both models given the port's position ids; the
  greedy tokens of `stream_generate(video=frames)` those of the JAX
  package's model on those inputs;
- position ids against transformers' `get_rope_index`: Qwen2.5-VL's with
  `second_per_grid_ts`, Qwen3-VL's on a timestamped prompt, and Qwen3-VL's
  placeholder text against transformers' processor;
- the vision cache's keys and the prefix cache's salts of two clips that
  share their first frame differ.

Each divergence from the JAX package is named in a test: its processor
ignores `videos` and its embedding drops video patches; its Qwen2.5-VL
steps a video's time by 1; its Qwen3-VL keeps Qwen2-VL's rope rule on a
timestamped prompt; its hashes read only a prefix of each array.  And
one from transformers 4.57.6: it casts Qwen2.5-VL's seconds per frame
group to an integer before scaling them.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mlx_vlm_tpu
import mlx_vlm_tpu_torch
from mlx_vlm_tpu import apc as japc
from mlx_vlm_tpu.models.qwen2_vl.language import \
    mrope_position_ids as jax_mrope
from mlx_vlm_tpu.utils.processing import \
    Qwen2VLImageProcessor as JaxImageProcessor
from mlx_vlm_tpu.utils.processing import load_video as jax_load_video
from mlx_vlm_tpu.vision_cache import VisionFeatureCache as JaxCache
from mlx_vlm_tpu_torch import apc as tapc
from mlx_vlm_tpu_torch.generate.common import embed_prompt
from mlx_vlm_tpu_torch.models.qwen2_vl.language import mrope_position_ids
from mlx_vlm_tpu_torch.ops import attention
from mlx_vlm_tpu_torch.utils import processing
from mlx_vlm_tpu_torch.utils.processing import (Qwen2VLImageProcessor,
                                                load_video, prepare_inputs,
                                                video_timestamps)
from mlx_vlm_tpu_torch.utils.testing import (qwen2_5_vl_hf_weights,
                                             qwen2_vl_hf_weights,
                                             qwen3_vl_hf_weights,
                                             qwen3_vl_moe_hf_weights,
                                             synthetic_video,
                                             tiny_qwen2_5_vl_config,
                                             tiny_qwen3_vl_config,
                                             tiny_qwen3_vl_moe_config)
from mlx_vlm_tpu_torch.vision_cache import VisionFeatureCache
from test_torch_qwen2_5_vl import bench_rule, write_checkpoint

torch.set_num_threads(2)

FAMILIES = ("qwen2_vl", "qwen2_5_vl", "qwen3_vl", "qwen3_vl_moe")


def _ids(base: dict) -> dict:
    return {k: base[k] for k in ("image_token_id", "video_token_id",
                                 "vision_start_token_id", "eos_token_id")}


def _qwen3(make, base: dict) -> dict:
    cfg = make(**_ids(base))
    cfg["text_config"] = dict(cfg["text_config"],
                              vocab_size=base["vocab_size"])
    cfg["vision_config"] = dict(cfg["vision_config"], patch_size=14)
    return cfg


CONFIGS = {
    "qwen2_vl": lambda base: base,
    "qwen2_5_vl": lambda base: tiny_qwen2_5_vl_config(
        vocab_size=base["vocab_size"], **_ids(base)),
    "qwen3_vl": lambda base: _qwen3(tiny_qwen3_vl_config, base),
    "qwen3_vl_moe": lambda base: _qwen3(tiny_qwen3_vl_moe_config, base),
}
WEIGHTS = {
    "qwen2_vl": lambda c: qwen2_vl_hf_weights(c, seed=11, scale=0.5),
    "qwen2_5_vl": lambda c: qwen2_5_vl_hf_weights(c, seed=11, scale=0.5),
    "qwen3_vl": lambda c: qwen3_vl_hf_weights(c, seed=11, scale=0.5),
    "qwen3_vl_moe": lambda c: qwen3_vl_moe_hf_weights(c, seed=11),
}


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """family -> (JAX (model, processor), port (model, processor)), each
    family's checkpoint written and loaded once."""
    cache = {}

    def get(name):
        if name not in cache:
            d = tmp_path_factory.mktemp(name)
            write_checkpoint(d, CONFIGS[name], WEIGHTS[name])
            get.paths[name] = d
            cache[name] = (mlx_vlm_tpu.load(str(d), dtype=jnp.float32),
                           mlx_vlm_tpu_torch.load(str(d), dtype=torch.float32,
                                                  device="cpu"))
        return cache[name]

    get.paths = {}
    return get


def write_clip(path, frames, fps: float) -> str:
    """`frames` written as an MJPG AVI at `fps` (cv2)."""
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f))
    writer.release()
    return str(path)


def clip(seed: int = 1, n: int = 4, h: int = 56, w: int = 84) -> np.ndarray:
    """A seeded clip of n frames, h x w (a multiple of 28: no resize)."""
    return synthetic_video(n, max(h, w), seed=seed)[:, :h, :w].copy()


def _image(seed: int = 2, h: int = 56, w: int = 56) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


VIDEO = "<|vision_start|><|video_pad|><|vision_end|>"
IMAGE = "<|vision_start|><|image_pad|><|vision_end|>"


def chat(body: str) -> str:
    return (f"<|im_start|>user\n{body}<|im_end|>\n"
            f"<|im_start|>assistant\n")


# ---------------------------------------------------------------- processor


@pytest.mark.parametrize("shape", [(4, 56, 84), (3, 56, 56), (2, 112, 84)])
def test_video_patches_and_grid_equal_the_reference(shape):
    n, h, w = shape
    frames = clip(3, n, h, w)
    got = Qwen2VLImageProcessor().videos([frames])
    flat, grid = JaxImageProcessor()._preprocess_one(list(frames))
    assert np.array_equal(got["pixel_values_videos"], flat.astype(np.float32))
    assert np.array_equal(got["video_grid_thw"], grid[None])
    assert got["video_grid_thw"][0, 0] == -(-n // 2)


def test_prepare_inputs_expands_the_video_token(disk):
    """<|video_pad|> becomes prod(grid) / 4 tokens, an image's token its
    own count; second_per_grid_ts is temporal_patch_size / fps.  The JAX
    package's processor ignores the video: no patches, one video token."""
    (jm, jp), (tm, tp) = disk("qwen2_vl")
    cfg = tm.config
    prompt = chat(IMAGE + VIDEO + VIDEO + "What happens?")
    videos = [clip(1), clip(2, 6)]
    inputs = prepare_inputs(tp, prompt, images=_image(), videos=videos,
                            fps=[2.0, 0.5])
    ids = inputs["input_ids"][0]
    vg, ig = inputs["video_grid_thw"], inputs["image_grid_thw"]
    assert vg.tolist() == [[2, 4, 6], [3, 4, 6]] and ig.tolist() == [[1, 4, 4]]
    assert (ids == cfg.video_token_id).sum() == vg.prod(-1).sum() // 4
    assert (ids == cfg.image_token_id).sum() == 4
    assert inputs["pixel_values_videos"].shape == (vg.prod(-1).sum(), 1176)
    assert np.allclose(inputs["second_per_grid_ts"], [1.0, 4.0])
    ref = mlx_vlm_tpu.utils.processing.prepare_inputs(
        jp, prompt, images=_image(), videos=videos)
    assert "pixel_values_videos" not in ref
    assert (ref["input_ids"][0] == cfg.video_token_id).sum() == 2


def test_frames_need_no_cv2(monkeypatch):
    """Frames given as an array or a list go through without cv2 (which the
    card's machine lacks); a path needs it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = clip(4)
    got, fps = load_video(frames)
    assert got is frames and fps == processing.DEFAULT_VIDEO_FPS
    got, fps = load_video(list(frames), fps=3.0)
    assert np.array_equal(got, frames) and fps == 3.0
    with pytest.raises(ImportError):
        load_video("clip.avi")
    with pytest.raises(ValueError):
        load_video(frames.astype(np.float32))


def test_load_video_reads_a_path_as_the_reference(tmp_path):
    path = write_clip(tmp_path / "clip.avi", clip(5, 30), 10.0)
    for kw in ({}, {"fps": 4.0}, {"nframes": 7}):
        got, rate = load_video(path, **kw)
        ref, ref_rate = jax_load_video(path, **kw)
        assert np.array_equal(got, ref) and rate == ref_rate
        assert got.shape[1:] == (56, 84, 3) and got.shape[0] % 2 == 0


def test_stream_generate_reads_a_path(disk, tmp_path):
    """A path goes through stream_generate (read with cv2 at `fps`) as its
    frames given do."""
    (_, _), (tm, tp) = disk("qwen2_vl")
    path = write_clip(tmp_path / "clip.avi", clip(6, 8), 4.0)
    frames, rate = load_video(path, fps=4.0)
    prompt = chat(VIDEO + "What happens?")
    a = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tp, prompt, video=path, fps=4.0, max_tokens=4)]
    b = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tp, prompt, video=frames, fps=rate, max_tokens=4)]
    assert a == b and len(a) == 4


def test_generate_command_takes_video_and_fps(disk, tmp_path, capsys):
    """`python -m mlx_vlm_tpu_torch generate --video PATH --fps F` puts a
    video part in the prompt and answers as stream_generate does on the
    same prompt and clip."""
    from mlx_vlm_tpu_torch.generate import cli

    (_, _), (tm, tp) = disk("qwen2_vl")
    path = write_clip(tmp_path / "clip.avi", clip(7, 8), 4.0)
    args = cli.parse_arguments(["--model", "m", "--video", path, "--fps",
                                "4"])
    assert args.video == [path] and args.fps == 4.0
    cli.main(["--model", str(disk.paths["qwen2_vl"]), "--video", path,
              "--fps", "4", "--prompt", "What happens?", "--max-tokens",
              "4", "--device", "cpu"])
    out = capsys.readouterr().out
    cm, cp = mlx_vlm_tpu_torch.load(str(disk.paths["qwen2_vl"]),
                                    device="cpu")  # as the command loads
    prompt = mlx_vlm_tpu_torch.apply_chat_template(
        cp, cm.config_dict, "What happens?", video=[path], fps=4, num_images=0)
    want = mlx_vlm_tpu_torch.generate(cm, cp, prompt, video=[path], fps=4.0,
                                      max_tokens=4)
    n = (prepare_inputs(tp, prompt, videos=[path], fps=4.0)["input_ids"]
         == tm.config.video_token_id).sum()
    assert f"Prompt: {want.prompt_tokens} tokens" in out and n == 4 * 6
    assert want.text in out


# ---------------------------------------------------------------- M-RoPE ids

MROPE_CASES = {
    "video": [("t", 3), ("v", 0), ("t", 4)],
    "image then video": [("t", 2), ("i", 0), ("t", 3), ("v", 0), ("t", 2)],
    "video then image": [("t", 2), ("v", 0), ("i", 0), ("t", 5)],
    "two videos and an image": [("v", 1), ("t", 1), ("i", 1), ("v", 0),
                                ("t", 3)],
}
IGRID = np.array([[1, 4, 6], [1, 8, 4]])
VGRID = np.array([[2, 4, 6], [3, 6, 4]])


def _mrope_ids(case, img=7, vid=8, pad=0):
    ids, used = [], {"i": 0, "v": 0}
    for kind, arg in case:
        if kind == "t":
            ids += [3] * arg
            continue
        grid = (IGRID if kind == "i" else VGRID)[used[kind]]
        used[kind] += 1
        ids += [img if kind == "i" else vid] * (int(np.prod(grid)) // 4)
    return np.array([[0] * pad + ids]), used


@pytest.mark.parametrize("case", list(MROPE_CASES))
@pytest.mark.parametrize("pad", [0, 3])
def test_mrope_ids_equal_the_reference(case, pad):
    ids, used = _mrope_ids(MROPE_CASES[case], pad=pad)
    mask = (np.arange(ids.shape[1]) >= pad).astype(np.int64)[None]
    grids = (IGRID[:used["i"]] if used["i"] else None,
             VGRID[:used["v"]] if used["v"] else None)
    kw = dict(merge=2, image_token_id=7, video_token_id=8)
    got = mrope_position_ids(ids, *grids, mask, **kw)
    ref = jax_mrope(ids, *grids, mask, **kw)
    for g, r in zip(got, ref):
        assert np.array_equal(g, np.asarray(r))


def test_qwen2_vl_video_positions_equal_the_reference(disk):
    (jm, jp), (tm, tp) = disk("qwen2_vl")
    inputs = prepare_inputs(tp, chat(IMAGE + "and" + VIDEO + "Describe."),
                            images=_image(), videos=clip(1))
    args = (inputs["input_ids"], inputs["image_grid_thw"],
            inputs["video_grid_thw"], inputs["attention_mask"])
    got = tm.prepare_position_ids(*args)
    ref = jm.prepare_position_ids(*args)
    assert all(np.array_equal(g, np.asarray(r)) for g, r in zip(got, ref))
    _, pos, deltas = embed_prompt(tm, inputs)
    assert np.array_equal(pos, got[0]) and np.array_equal(deltas, got[1])


# ---------------------------------------------------------- vision attention


def _masked(q, k, v, scale, runs):
    """The towers' former attention: every patch at once under the [N, N]
    block-diagonal mask of `runs`."""
    seg = torch.cat([torch.full((n,), len(runs) * 1000 + i * 100 + j)
                     for i, (_, n, count) in enumerate(runs)
                     for j in range(count)])
    mask = (seg[None, :] == seg[:, None])[None, None]
    return attention.sdpa(q, k, v, scale, mask)


@pytest.mark.parametrize("lengths", [[16], [16, 16, 16, 16], [16, 4, 16, 4],
                                     [9, 9, 4, 9, 4, 1]])
@pytest.mark.parametrize("budget", [1 << 30, 1])
def test_segment_sdpa_equals_the_masked_sdpa(lengths, budget, monkeypatch):
    g = torch.Generator().manual_seed(sum(lengths))
    N = sum(lengths)
    q, k, v = (torch.randn((1, 4, N, 8), generator=g) for _ in range(3))
    seg = torch.repeat_interleave(torch.arange(len(lengths)),
                                  torch.tensor(lengths))
    runs = attention.segment_runs(seg)
    assert sum(n * c for _, n, c in runs) == N
    monkeypatch.setattr(attention, "SEGMENT_SCORE_BYTES", budget)
    got = attention.segment_sdpa(q, k, v, 0.35, runs)
    mask = (seg[None, :] == seg[:, None])[None, None]
    ref = attention.sdpa(q, k, v, 0.35, mask)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


TOWER_GRIDS = {"images": [[1, 4, 6], [1, 8, 4]], "4-frame clip": [[2, 4, 6]],
               "image and clip": [[1, 6, 6], [2, 4, 6]]}


@pytest.mark.parametrize("grid", list(TOWER_GRIDS))
@pytest.mark.parametrize("family", ["qwen2_vl", "qwen2_5_vl", "qwen3_vl"])
def test_towers_attend_per_segment_as_the_masked_sdpa(disk, family, grid,
                                                      monkeypatch):
    (_, _), (tm, _) = disk(family)
    grid = np.array(TOWER_GRIDS[grid])
    n = int(grid.prod(-1).sum())
    pix = torch.from_numpy((np.random.default_rng(n).standard_normal(
        (n, 1176)) * 0.5).astype(np.float32))
    aux = {k: torch.from_numpy(np.asarray(v))
           for k, v in tm.vision_aux_inputs(grid).items()}
    run = getattr(tm, "vision_features", None) or tm.tower_features
    got = run(tm.params, pix, **aux)
    module = sys.modules[type(tm.vision_tower).__module__]
    monkeypatch.setattr(module, "segment_sdpa", _masked)
    ref = run(tm.params, pix, **aux)
    for g, r in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, ref))):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------- embeddings and logits


def jax_embeds(jm, inputs):
    """The JAX package's embeddings of `inputs` with its patches: the
    image's rows, then the video's, as one stream with one grid (right
    wherever every image comes before every video)."""
    keys = [k for k in ("pixel_values", "pixel_values_videos") if k in inputs]
    grid = np.concatenate([inputs[g] for g in ("image_grid_thw",
                                               "video_grid_thw")
                           if g in inputs])
    aux = {k: jnp.asarray(v) for k, v in jm.vision_aux_inputs(grid).items()}
    pix = np.concatenate([inputs[k] for k in keys])
    return jm.get_input_embeddings(jm.params, jnp.asarray(inputs["input_ids"]),
                                   jnp.asarray(pix), **aux)


def forced(jm, tm, inputs, n_steps=5, capacity=256):
    """(JAX logits [n, V], port logits [n, V]): the prompt (the JAX model
    fed the port's position ids), then n - 1 decode steps fed the JAX
    model's greedy tokens; and the embeddings' largest distance."""
    te, pos, deltas = embed_prompt(tm, inputs)
    je = jax_embeds(jm, inputs)
    scale = max(1.0, float(np.abs(np.asarray(je)).max()))
    emb_err = float(np.abs(np.asarray(je) - te.numpy()).max()) / scale
    jc = jm.language_model.init_cache(1, capacity, jnp.float32)
    tc = tm.language_model.init_cache(1, capacity, torch.float32)
    jl, jc = jm(jm.params, je, jc, jnp.asarray(pos))
    tl = tm(tm.params, te, tc, torch.from_numpy(pos.astype(np.int64)))
    ref, got = [np.asarray(jl[0, -1])], [tl[0, -1].numpy()]
    for _ in range(n_steps - 1):
        tok = int(np.argmax(ref[-1]))
        p = int(deltas[0, 0]) + int(jc.offset)
        jl, jc = jm(jm.params, jm.language_model.embed(
            jm.params["language_model"], jnp.asarray([[tok]])), jc,
            jnp.full((3, 1, 1), p, jnp.int32))
        tl = tm(tm.params, tm.language_model.embed(
            tm.params["language_model"], torch.tensor([[tok]])), tc,
            torch.full((3, 1, 1), p))
        ref.append(np.asarray(jl[0, 0]))
        got.append(tl[0, 0].numpy())
    return np.stack(ref), np.stack(got), emb_err


PROMPTS = {"video": (VIDEO + "What happens in this video?", False),
           "image and video": (IMAGE + "then" + VIDEO + "Compare them.", True)}


@pytest.mark.parametrize("prompt", list(PROMPTS))
@pytest.mark.parametrize("family", FAMILIES)
def test_video_embeddings_and_logits_match_jax(disk, family, prompt):
    (jm, _), (tm, tp) = disk(family)
    body, with_image = PROMPTS[prompt]
    inputs = prepare_inputs(tp, chat(body), videos=clip(1),
                            images=_image() if with_image else None)
    ref, got, emb_err = forced(jm, tm, inputs)
    assert emb_err <= 1e-4
    err, tol, margin_ok, same = bench_rule(ref, got)
    assert err <= tol and np.all(same[margin_ok])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_stream_generate_answers_a_video(disk, family):
    """stream_generate(video=frames) and generate() give the JAX package's
    model's greedy tokens on the same inputs (its own stream_generate
    drops the video's patches)."""
    (jm, _), (tm, tp) = disk(family)
    prompt = mlx_vlm_tpu_torch.apply_chat_template(
        tp, tm.config_dict, "What happens in this video?", video=clip(1),
        num_images=0)
    assert VIDEO in prompt
    inputs = prepare_inputs(tp, prompt, videos=clip(1))
    ref, _, _ = forced(jm, tm, inputs, n_steps=6)
    toks = [r.token for r in mlx_vlm_tpu_torch.stream_generate(
        tm, tp, prompt, video=clip(1), max_tokens=6)]
    assert toks == [int(t) for t in ref.argmax(-1)]
    res = mlx_vlm_tpu_torch.generate(tm, tp, prompt, video=clip(1),
                                     max_tokens=6)
    assert res.generation_tokens == 6 and res.prompt_tokens == \
        inputs["input_ids"].shape[1]


def test_reference_embedding_drops_the_video(disk):
    """The JAX package's stream_generate reads `pixel_values` only
    (dispatch.py:94-98): with the port's processor output its prompt's video
    tokens keep their text embeddings, where the port's get the tower's."""
    (jm, _), (tm, tp) = disk("qwen2_vl")
    inputs = prepare_inputs(tp, chat(VIDEO + "Describe."), videos=clip(1))
    text_only = np.asarray(jm.get_input_embeddings(
        jm.params, jnp.asarray(inputs["input_ids"])))
    got = embed_prompt(tm, inputs)[0].numpy()
    vid = inputs["input_ids"][0] == tm.config.video_token_id
    assert np.abs(got[0, vid] - text_only[0, vid]).min() > 1e-3
    assert np.array_equal(got[0, ~vid], text_only[0, ~vid])


# --------------------------------------------- positions against transformers


def _hf_self(tm):
    """The `self` that transformers' get_rope_index reads: its config."""
    cfg = tm.config
    return types.SimpleNamespace(config=types.SimpleNamespace(
        vision_config=cfg.vision_config, image_token_id=cfg.image_token_id,
        video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id))


def _hf_tensors(inputs, *keys):
    return [None if inputs.get(k) is None else torch.from_numpy(
        np.asarray(inputs[k])) for k in keys]


@pytest.mark.parametrize("fps", [[2.0], [1.0], [0.5], [2.0, 0.5]])
def test_qwen2_5_vl_positions_equal_transformers(disk, fps):
    """Qwen2.5-VL's time positions step by second_per_grid_ts *
    tokens_per_second (2 here) a frame group, as transformers'
    get_rope_index steps them; the JAX package steps them by 1."""
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import \
        Qwen2_5_VLModel

    (jm, _), (tm, tp) = disk("qwen2_5_vl")
    videos = [clip(1, 6), clip(2)][:len(fps)]
    body = IMAGE + "and" + "".join([VIDEO] * len(fps)) + "Compare."
    inputs = prepare_inputs(tp, chat(body), images=_image(), videos=videos,
                            fps=fps)
    _, pos, deltas = embed_prompt(tm, inputs)
    ids, ig, vg, spg, mask = _hf_tensors(
        inputs, "input_ids", "image_grid_thw", "video_grid_thw",
        "second_per_grid_ts", "attention_mask")
    ref_pos, ref_deltas = Qwen2_5_VLModel.get_rope_index(
        _hf_self(tm), ids, ig, vg, spg, mask)
    assert np.array_equal(pos, ref_pos.numpy())
    assert np.array_equal(deltas, ref_deltas.numpy())
    jpos, _ = jm.prepare_position_ids(
        inputs["input_ids"], inputs["image_grid_thw"],
        inputs["video_grid_thw"], inputs["attention_mask"])
    assert not np.array_equal(pos, np.asarray(jpos))


def test_qwen2_5_vl_fractional_seconds_diverge_from_transformers_4_57_6(disk):
    """At fps 4 a frame group spans 0.5 s.  The port steps time by
    floor(g * 0.5 * 2) = g, as Qwen2.5-VL's original get_rope_index (a
    float product) does; transformers 4.57.6 casts 0.5 to the index dtype
    first, so every frame group there takes time 0."""
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import \
        Qwen2_5_VLModel

    (_, _), (tm, tp) = disk("qwen2_5_vl")
    inputs = prepare_inputs(tp, chat(VIDEO + "Describe."), videos=clip(1, 6),
                            fps=4.0)
    _, pos, _ = embed_prompt(tm, inputs)
    ids, vg, spg = _hf_tensors(inputs, "input_ids", "video_grid_thw",
                               "second_per_grid_ts")
    ref, _ = Qwen2_5_VLModel.get_rope_index(_hf_self(tm), ids, None, vg, spg)
    vid = inputs["input_ids"][0] == tm.config.video_token_id
    start = pos[0, 0, vid].min()
    assert sorted(set((pos[0, 0, vid] - start).tolist())) == [0, 1, 2]
    assert len(set(ref.numpy()[0, 0, vid].tolist())) == 1


@pytest.mark.parametrize("family", ["qwen3_vl", "qwen3_vl_moe"])
def test_qwen3_vl_positions_equal_transformers(disk, family):
    """On the timestamped prompt each frame group is its own span: the
    port splits the video's grid per frame group as transformers does.
    The JAX package keeps one span of the whole grid: it runs past the
    first group's tokens over the timestamps into the next groups, then
    finds video tokens left and no grid for them (IndexError)."""
    from transformers.models.qwen3_vl.modeling_qwen3_vl import Qwen3VLModel

    (jm, _), (tm, tp) = disk(family)
    inputs = prepare_inputs(tp, chat(IMAGE + "and" + VIDEO + "Compare."),
                            images=_image(), videos=clip(1, 6), fps=1.5)
    _, pos, deltas = embed_prompt(tm, inputs)
    ids, ig, vg, mask = _hf_tensors(inputs, "input_ids", "image_grid_thw",
                                    "video_grid_thw", "attention_mask")
    ref_pos, ref_deltas = Qwen3VLModel.get_rope_index(_hf_self(tm), ids, ig,
                                                      vg, mask)
    assert np.array_equal(pos, ref_pos.numpy())
    assert np.array_equal(deltas, ref_deltas.numpy())
    with pytest.raises(IndexError):
        jm.prepare_position_ids(
            inputs["input_ids"], inputs["image_grid_thw"],
            inputs["video_grid_thw"], inputs["attention_mask"])


class _HFVideo:
    """transformers' video processor as the Qwen3-VL processor reads it: a
    grid and the frames' metadata (indices and rate)."""

    merge_size = 2

    def __init__(self, grids, metadata):
        self.grids, self.metadata = grids, metadata

    def __call__(self, videos=None, **kw):
        return {"video_grid_thw": torch.tensor(self.grids),
                "video_metadata": self.metadata}


class _HFText:
    """A tokenizer that records the text it is given."""

    init_kwargs: dict = {}

    def __call__(self, text, **kw):
        self.text = text
        return {"input_ids": [[0]] * len(text)}


@pytest.mark.parametrize("frames,fps", [(4, 2.0), (5, 1.5), (8, 24.0)])
def test_qwen3_vl_timestamps_equal_transformers(disk, frames, fps):
    """The port's Qwen3-VL processor writes each frame group as
    transformers' processor does: "<{t:.1f} seconds>", then the group's
    tokens between a vision start / end pair."""
    from transformers.models.qwen3_vl.processing_qwen3_vl import \
        Qwen3VLProcessor
    from transformers.video_utils import VideoMetadata

    (_, _), (tm, tp) = disk("qwen3_vl")
    assert tp.video_timestamps
    video = clip(3, frames)
    text = chat(VIDEO + "What happens?")
    ours = prepare_inputs(tp, text, videos=video, fps=fps)
    grid = ours["video_grid_thw"].tolist()
    hf = object.__new__(Qwen3VLProcessor)
    hf.image_token, hf.video_token = "<|image_pad|>", "<|video_pad|>"
    hf.vision_start_token = "<|vision_start|>"
    hf.vision_end_token = "<|vision_end|>"
    hf.tokenizer = _HFText()
    hf.video_processor = _HFVideo(grid, [VideoMetadata(
        total_num_frames=frames, fps=fps,
        frames_indices=list(range(frames)))])
    hf._check_special_mm_tokens = lambda *a, **k: None
    try:
        hf(text=text, videos=[video])
    except Exception:  # noqa: BLE001 — the text is recorded before
        pass
    want = tp.tokenizer(hf.tokenizer.text, return_tensors="np")["input_ids"]
    assert np.array_equal(ours["input_ids"], want)
    assert f"<{video_timestamps(frames, fps)[-1]:.1f} seconds>" in \
        hf.tokenizer.text[0]


# ------------------------------------------------------------------- keys


def test_clips_sharing_a_first_frame_get_different_keys(disk):
    """Two clips that open on the same frames: the port's vision-cache keys
    and prefix-cache salts differ; the JAX package's, which read only the
    first 256 KiB / 64 KiB of the array, are equal."""
    (_, _), (tm, tp) = disk("qwen2_vl")
    a = clip(1, 4, 112, 112)
    b = a.copy()
    b[2:] = clip(9, 2, 112, 112)
    ins = [prepare_inputs(tp, chat(VIDEO + "Describe."), videos=v)
           for v in (a, b)]
    pv = [i["pixel_values_videos"] for i in ins]
    grid = ins[0]["video_grid_thw"]
    assert pv[0].nbytes > 262144 and np.array_equal(pv[0][:64], pv[1][:64])
    assert VisionFeatureCache.key(pv[0], grid) != \
        VisionFeatureCache.key(pv[1], grid)
    assert JaxCache.key(pv[0], grid) == JaxCache.key(pv[1], grid)
    salts = [tapc.prompt_key(tm, i)[1] for i in ins]
    assert salts[0] != salts[1]
    assert japc.semantic_extra_hash("qwen2_vl", [pv[0]]) == \
        japc.semantic_extra_hash("qwen2_vl", [pv[1]])
    # the salt reads the video: the same tokens without it salt otherwise
    text = dict(ins[0])
    for k in ("pixel_values_videos", "video_grid_thw"):
        text.pop(k)
    assert tapc.prompt_key(tm, text)[1] != salts[0]


def test_vision_cache_keys_the_video_by_its_own_array(disk):
    """With a vision cache, an image + video prompt stores two entries (the
    image's features and the video's), and a second embedding hits both
    and gives the same embeddings."""
    (_, _), (tm, tp) = disk("qwen2_vl")
    inputs = prepare_inputs(tp, chat(IMAGE + VIDEO + "Compare."),
                            images=_image(), videos=clip(1))
    vc = VisionFeatureCache()
    e1 = embed_prompt(tm, inputs, vision_cache=vc)[0]
    assert len(vc._store) == 2 and vc.misses == 2 and vc.hits == 0
    e2 = embed_prompt(tm, inputs, vision_cache=vc)[0]
    assert vc.hits == 2 and torch.equal(e1, e2)
    assert torch.equal(e1, embed_prompt(tm, inputs)[0])


def test_models_without_a_video_token_refuse_video():
    from mlx_vlm_tpu_torch.utils.loader import load_model_from_weights
    from mlx_vlm_tpu_torch.utils.processing import LlavaProcessor
    from mlx_vlm_tpu_torch.utils.testing import (llava_hf_weights,
                                                 tiny_llava_config)

    cfg = tiny_llava_config()
    model = load_model_from_weights(cfg, llava_hf_weights(cfg), torch.float32,
                                    "cpu")
    with pytest.raises(NotImplementedError, match="video"):
        next(mlx_vlm_tpu_torch.stream_generate(model, None, "hi",
                                               video=clip(1)))
    proc = LlavaProcessor(None, None)
    with pytest.raises(NotImplementedError):
        proc(text="hi", videos=[clip(1)])

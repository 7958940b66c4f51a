"""Preprocessing: images -> pixel arrays, prompt -> token ids.

Port of mlx_vlm_tpu/utils/processing.py (load_image :24, load_video :55,
smart_resize :127, Qwen2VLImageProcessor :150, Qwen2VLProcessor :273,
load_processor :390, prepare_inputs :420) for images, videos and text;
the image processor's patch, merge and temporal sizes follow the
checkpoint (`image_processor_for`).
LLaVA gets a CLIP image processor and a processor that expands each image
token (`ClipImageProcessor`, `LlavaProcessor`), and PaliGemma a SigLIP
image processor and a processor that writes transformers' PaliGemma
prompt (`SiglipImageProcessor`, `PaliGemmaProcessor`), each picked by
model type in `load_processor`: the reference has neither and gives both
the Qwen2-VL fallback, whose patch rows their towers cannot take (ROADMAP,
known faults in the reference).
PIL, cv2 and transformers are imported only inside the functions that use
them: a uint8 [H, W, 3] array, or a video's uint8 [T, H, W, 3] frames,
whose size already meets the resize rule goes through without PIL, and a
video given as frames needs no cv2.

A video becomes `pixel_values_videos` and `video_grid_thw` (its frames
through the image processor's patching, `_preprocess_one`), its
<|video_pad|> token prod(grid) / merge^2 of them, and
`second_per_grid_ts` = temporal_patch_size / fps (transformers'
processing_qwen2_5_vl.py:154-161), `fps` being the rate of the frames
given (`DEFAULT_VIDEO_FPS` unless the caller says; a path's frames are
sampled by `load_video` at the rate it reports).  A processor made with
`video_timestamps` (Qwen3-VL's) writes each frame group as
"<{t:.1f} seconds>" and a vision start / end pair around its tokens, as
transformers' processing_qwen3_vl.py:196-230 does.  The JAX package's
processor ignores `videos` (ROADMAP's known faults in the reference).
Audio inputs are not ported.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Union

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# the frame rate of a video given as frames when the caller names none
# (transformers' Qwen2.5-VL processor's default fps)
DEFAULT_VIDEO_FPS = 2.0


def load_image(source):
    """Path / URL / data URI / PIL image -> RGB PIL image; a uint8 [H, W, 3]
    array is returned as it is."""
    if isinstance(source, np.ndarray):
        if source.dtype != np.uint8 or source.ndim != 3 or source.shape[2] != 3:
            raise ValueError("image arrays must be uint8 [H, W, 3]")
        return source
    from PIL import Image, ImageOps

    if hasattr(source, "convert"):
        img = source
    elif isinstance(source, (str, Path)):
        s = str(source)
        if s.startswith("http://") or s.startswith("https://"):
            import io
            import urllib.request

            with urllib.request.urlopen(s) as r:
                img = Image.open(io.BytesIO(r.read()))
        elif s.startswith("data:image"):
            import base64
            import io

            img = Image.open(io.BytesIO(base64.b64decode(s.split(",", 1)[1])))
        else:
            img = Image.open(s)
    else:
        raise ValueError(f"cannot load image from {type(source)}")
    img = ImageOps.exif_transpose(img)
    return img.convert("RGB")


def load_video(source, nframes=None, fps=None, frame_factor: int = 2,
               max_frames: int = 64):
    """A video -> (frames [T, H, W, 3] uint8, their rate in frames a second).

    Frames given as a uint8 [T, H, W, 3] array or a list of frames (uint8
    [H, W, 3] arrays or PIL images) pass through as they are, at `fps`
    (DEFAULT_VIDEO_FPS when None); no cv2 is needed.  A path is read with
    cv2 as the reference reads it: `nframes` frames, or those that `fps`
    (default 1) a second gives, at most `max_frames`, rounded down to a
    multiple of `frame_factor`, spread evenly over the video; the rate
    returned is the frames' over the video's length."""
    if isinstance(source, (list, tuple)):
        source = np.stack([np.asarray(load_image(f)) for f in source])
    if isinstance(source, np.ndarray):
        if source.dtype != np.uint8 or source.ndim != 4 or source.shape[3] != 3:
            raise ValueError("video frames must be uint8 [T, H, W, 3]")
        return source, float(fps) if fps else DEFAULT_VIDEO_FPS
    import cv2

    cap = cv2.VideoCapture(str(source))
    if not cap.isOpened():
        raise ValueError(f"cannot open video {source}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    video_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if nframes is None:
        nframes = int(total / video_fps * (fps or 1.0))
    nframes = max(frame_factor, min(nframes, total, max_frames))
    nframes = (nframes // frame_factor) * frame_factor
    frames = []
    for idx in np.linspace(0, total - 1, nframes).round().astype(int):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {source}")
    return np.stack(frames), nframes / max(total / video_fps, 1e-6)


def video_timestamps(n_frames: int, fps: float,
                     temporal_patch_size: int = 2) -> list:
    """Seconds of each frame group of `n_frames` frames at `fps`: the mean
    time of the group's first and last frame, the frame count padded with
    the last frame to a multiple of the group (transformers'
    processing_qwen3_vl.py:314-325, which groups by the merge size, equal
    to the temporal patch size in Qwen3-VL's configs)."""
    g = temporal_patch_size
    idx = list(range(n_frames))
    idx += [idx[-1]] * (-len(idx) % g)
    t = [i / fps for i in idx]
    return [(t[i] + t[i + g - 1]) / 2 for i in range(0, len(t), g)]


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280):
    """Qwen2-VL resize rule: dims divisible by `factor`, area within bounds."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


class Qwen2VLImageProcessor:
    """Numpy Qwen2-VL image processor (patch layout matches HF exactly)."""

    def __init__(self, patch_size: int = 14, merge_size: int = 2,
                 temporal_patch_size: int = 2, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280,
                 image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD):
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.temporal_patch_size = temporal_patch_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)

    def _preprocess_one(self, frames: List[np.ndarray]):
        """frames: T uint8 [H, W, 3] frames of one image or video ->
        (patches, grid).

        The bicubic resize is skipped when the rule keeps the size: PIL then
        returns an identical copy."""
        h, w = frames[0].shape[:2]
        hb, wb = smart_resize(h, w, self.patch_size * self.merge_size,
                              self.min_pixels, self.max_pixels)
        proc = []
        for f in frames:
            if (hb, wb) != (h, w):
                from PIL import Image

                f = np.asarray(Image.fromarray(f).resize((wb, hb), Image.BICUBIC))
            x = np.asarray(f, np.float32) / 255.0
            x = (x - self.image_mean) / self.image_std
            proc.append(x.transpose(2, 0, 1))  # CHW
        patches = np.stack(proc)  # [T, C, H, W]
        T = patches.shape[0]
        if T % self.temporal_patch_size:
            reps = self.temporal_patch_size - T % self.temporal_patch_size
            patches = np.concatenate([patches, np.tile(patches[-1:], (reps, 1, 1, 1))])
        C = patches.shape[1]
        gt = patches.shape[0] // self.temporal_patch_size
        gh, gw = hb // self.patch_size, wb // self.patch_size
        m, P = self.merge_size, self.patch_size
        patches = patches.reshape(
            gt, self.temporal_patch_size, C, gh // m, m, P, gw // m, m, P)
        patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
        flat = patches.reshape(gt * gh * gw, C * self.temporal_patch_size * P * P)
        return flat, np.array([gt, gh, gw], np.int64)

    def __call__(self, images) -> dict:
        """images: image-likes or a list of them -> pixel_values [N, D], grids."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        flats, grids = [], []
        for im in images:
            flat, grid = self._preprocess_one([np.asarray(load_image(im))])
            flats.append(flat)
            grids.append(grid)
        return {
            "pixel_values": np.concatenate(flats, axis=0).astype(np.float32),
            "image_grid_thw": np.stack(grids),
        }

    def videos(self, videos) -> dict:
        """videos: uint8 [T, H, W, 3] frame arrays -> pixel_values_videos
        [N, D] and video_grid_thw, each video's T frames patched together
        (T padded with its last frame to a multiple of the temporal patch
        size)."""
        flats, grids = [], []
        for frames in videos:
            flat, grid = self._preprocess_one(list(frames))
            flats.append(flat)
            grids.append(grid)
        return {
            "pixel_values_videos": np.concatenate(flats, axis=0).astype(
                np.float32),
            "video_grid_thw": np.stack(grids),
        }


def _expand(texts: list, token: str, placeholders) -> list:
    """Each `token` in `texts`, in order, replaced by the next of
    `placeholders` (strings that may hold `token`)."""
    out = []
    for t in texts:
        pieces = t.split(token)
        t = pieces[0]
        for rest in pieces[1:]:
            t += next(placeholders) + rest
        out.append(t)
    return out


class Qwen2VLProcessor:
    """Minimal text + image + video processor mirroring the HF behaviour;
    with `video_timestamps`, Qwen3-VL's video placeholders."""

    image_pad = "<|image_pad|>"
    video_pad = "<|video_pad|>"
    vision_start = "<|vision_start|>"
    vision_end = "<|vision_end|>"

    def __init__(self, tokenizer, image_processor: Qwen2VLImageProcessor,
                 video_timestamps: bool = False):
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.video_timestamps = video_timestamps

    def _video_placeholders(self, grids, n_frames: list, fps: list):
        merge2 = self.image_processor.merge_size**2
        tps = self.image_processor.temporal_patch_size
        for (t, h, w), n, rate in zip(grids, n_frames, fps):
            frame = int(h * w) // merge2
            if not self.video_timestamps:
                yield self.video_pad * (int(t) * frame)
                continue
            yield "".join(
                f"<{s:.1f} seconds>{self.vision_start}"
                f"{self.video_pad * frame}{self.vision_end}"
                for s in video_timestamps(n, rate, tps))

    def __call__(self, text=None, images=None, videos=None, padding=True,
                 audio=None, fps=None, **kw):
        """`videos`: uint8 [T, H, W, 3] frame arrays; `fps`: their rates (a
        number for all, or one per video; DEFAULT_VIDEO_FPS when None)."""
        if audio is not None:
            raise NotImplementedError("audio inputs are not ported")
        out = {}
        texts = [text] if isinstance(text, str) else list(text)
        if images is not None:
            out.update(self.image_processor(images))
            merge2 = self.image_processor.merge_size**2
            texts = _expand(texts, self.image_pad, iter(
                self.image_pad * (int(np.prod(g)) // merge2)
                for g in out["image_grid_thw"]))
        if videos is not None:
            out.update(self.image_processor.videos(videos))
            fps = fps if fps is not None else DEFAULT_VIDEO_FPS
            fps = [float(f) for f in (fps if isinstance(fps, (list, tuple))
                                      else [fps] * len(videos))]
            if len(fps) != len(videos):
                raise ValueError(f"{len(fps)} fps values for {len(videos)} "
                                 f"videos")
            tps = self.image_processor.temporal_patch_size
            out["second_per_grid_ts"] = np.asarray([tps / f for f in fps],
                                                   np.float32)
            spans = self._video_placeholders(
                out["video_grid_thw"], [len(v) for v in videos], fps)
            if self.video_timestamps:  # the whole start / pad / end triple
                triple = self.vision_start + self.video_pad + self.vision_end
                texts = [t.replace(triple, self.video_pad) for t in texts]
            texts = _expand(texts, self.video_pad, spans)
        enc = self.tokenizer(texts, return_tensors="np", padding=padding,
                             padding_side="left")
        out["input_ids"] = np.asarray(enc["input_ids"])
        out["attention_mask"] = np.asarray(enc["attention_mask"])
        return out

    def apply_chat_template(self, messages, **kwargs):
        return self.tokenizer.apply_chat_template(messages, **kwargs)


def _preprocessor_config(model_path) -> dict:
    """A checkpoint's preprocessor_config.json ({} without one)."""
    pre = Path(model_path) / "preprocessor_config.json" if model_path else None
    if pre is None or not pre.exists():
        return {}
    import json

    with open(pre) as f:
        return json.load(f)


def image_processor_for(model=None, model_path=None) -> Qwen2VLImageProcessor:
    """The numpy image processor of a checkpoint: the sizes and the
    normalization of its preprocessor_config.json when it has one, else its
    vision config's patch, merge and temporal sizes (Qwen3-VL's patch is 16,
    so its merged tokens cover 32 x 32 pixels) with Qwen2-VL's defaults
    for the rest.  The reference's fallback builds Qwen2VLImageProcessor()
    (patch 14) for every model (ROADMAP's known faults in the reference)."""
    kw = {}
    vc = getattr(getattr(model, "config", None), "vision_config", None)
    if vc is not None:
        kw = {"patch_size": vc.patch_size,
              "merge_size": vc.spatial_merge_size,
              "temporal_patch_size": vc.temporal_patch_size}
    pc = _preprocessor_config(model_path)
    if pc:
        for k in ("patch_size", "merge_size", "temporal_patch_size",
                  "min_pixels", "max_pixels", "image_mean", "image_std"):
            if pc.get(k) is not None:
                kw[k] = pc[k]
        size = pc.get("size") or {}
        if size.get("shortest_edge") is not None and "min_pixels" not in pc:
            kw["min_pixels"] = size["shortest_edge"]
        if size.get("longest_edge") is not None and "max_pixels" not in pc:
            kw["max_pixels"] = size["longest_edge"]
    return Qwen2VLImageProcessor(**kw)


class ClipImageProcessor:
    """Numpy CLIP image processor (HF CLIPImageProcessor's defaults): the
    shortest edge resized to `size` (bicubic), a center crop of
    `crop_size`, rescale by 1/255 (in float64, then float32, as HF does),
    normalize with the mean and std.  Returns pixel_values [N, 3, H, W]
    float32 and no grid."""

    def __init__(self, size: int = 336, crop_size=(336, 336),
                 image_mean=OPENAI_CLIP_MEAN, image_std=OPENAI_CLIP_STD,
                 rescale_factor: float = 1 / 255):
        self.size = int(size)
        self.crop_size = tuple(int(c) for c in crop_size)
        self.image_mean = np.asarray(image_mean, np.float32)
        self.image_std = np.asarray(image_std, np.float32)
        self.rescale_factor = rescale_factor

    def _preprocess_one(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        short, long = (w, h) if w <= h else (h, w)
        new_long = int(self.size * long / short)
        hb, wb = (new_long, self.size) if w <= h else (self.size, new_long)
        if (hb, wb) != (h, w):  # PIL returns an identical copy otherwise
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize((wb, hb),
                                                         Image.BICUBIC))
        ch, cw = self.crop_size
        if ch > hb or cw > wb:  # HF pads a short image with zeros
            H, W = max(ch, hb), max(cw, wb)
            top, left = -(-(H - hb) // 2), -(-(W - wb) // 2)
            pad = np.zeros((H, W, 3), img.dtype)
            pad[top:top + hb, left:left + wb] = img
            img, hb, wb = pad, H, W
        top, left = (hb - ch) // 2, (wb - cw) // 2
        img = img[top:top + ch, left:left + cw]
        x = (img.astype(np.float64) * self.rescale_factor).astype(np.float32)
        x = (x - self.image_mean) / self.image_std
        return x.transpose(2, 0, 1)

    def __call__(self, images) -> dict:
        if not isinstance(images, (list, tuple)):
            images = [images]
        return {"pixel_values": np.stack([
            self._preprocess_one(np.asarray(load_image(im)))
            for im in images]).astype(np.float32)}


class LlavaProcessor:
    """Text + image processor for LLaVA: each `image_token` in the text
    becomes `num_image_tokens` of them, one for each feature the tower and
    projector give an image ((image_size / patch)^2 patches, and CLS
    unless the "default" strategy drops it: 576 at 336 / 14)."""

    def __init__(self, tokenizer, image_processor: ClipImageProcessor,
                 image_token: str = "<image>", num_image_tokens: int = 576):
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.image_token = image_token
        self.num_image_tokens = num_image_tokens

    def __call__(self, text=None, images=None, videos=None, padding=True,
                 audio=None, **kw):
        if videos is not None or audio is not None:
            raise NotImplementedError("video and audio inputs are not ported")
        out = {}
        texts = [text] if isinstance(text, str) else list(text)
        if images is not None:
            out.update(self.image_processor(images))
            texts = [t.replace(self.image_token,
                               self.image_token * self.num_image_tokens)
                     for t in texts]
        enc = self.tokenizer(texts, return_tensors="np", padding=padding,
                             padding_side="left")
        out["input_ids"] = np.asarray(enc["input_ids"])
        out["attention_mask"] = np.asarray(enc["attention_mask"])
        return out

    def apply_chat_template(self, messages, **kwargs):
        return self.tokenizer.apply_chat_template(messages, **kwargs)


class SiglipImageProcessor(ClipImageProcessor):
    """Numpy SigLIP image processor (transformers' SiglipImageProcessor's
    defaults): a bicubic resize to `size` x `size`, rescale by 1/255 (in
    float64, then float32), normalize with mean and std 0.5.  Returns
    pixel_values [N, 3, size, size] float32 and no grid."""

    def __init__(self, size: int = 224, image_mean=(0.5, 0.5, 0.5),
                 image_std=(0.5, 0.5, 0.5), rescale_factor: float = 1 / 255):
        super().__init__(size, (size, size), image_mean, image_std,
                         rescale_factor)

    def _preprocess_one(self, img: np.ndarray) -> np.ndarray:
        side = self.size
        if img.shape[:2] != (side, side):  # PIL returns a copy otherwise
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize((side, side),
                                                         Image.BICUBIC))
        x = (img.astype(np.float64) * self.rescale_factor).astype(np.float32)
        x = (x - self.image_mean) / self.image_std
        return x.transpose(2, 0, 1)


class PaliGemmaProcessor:
    """Text + image processor for PaliGemma, as transformers'
    processing_paligemma.py builds its prompt: a prompt without
    `image_token` becomes `num_image_tokens` image tokens, BOS, the prompt
    and "\n" (`build_string_from_input`, one image a prompt); one with it
    has each image token expanded and BOS after the last, then "\n".  The
    tokenizer adds no special token of its own.  Like transformers', it
    takes no prompt without an image."""

    def __init__(self, tokenizer, image_processor: SiglipImageProcessor,
                 image_token: str = "<image>", num_image_tokens: int = 256,
                 bos_token: str = "<bos>"):
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.image_token = image_token
        self.num_image_tokens = num_image_tokens
        self.bos_token = bos_token

    def _prompt(self, text: str) -> str:
        tok = self.image_token
        if tok not in text:
            return f"{tok * self.num_image_tokens}{self.bos_token}{text}\n"
        text = text.replace(tok, tok * self.num_image_tokens)
        at = text.rfind(tok) + len(tok)
        return f"{text[:at]}{self.bos_token}{text[at:]}\n"

    def __call__(self, text=None, images=None, videos=None, padding=True,
                 audio=None, **kw):
        if videos is not None or audio is not None:
            raise NotImplementedError("video and audio inputs are not ported")
        if images is None:
            raise ValueError("`images` are expected as arguments to a "
                             "`PaliGemmaProcessor` instance.")
        texts = [text or ""] if text is None or isinstance(text, str) \
            else list(text)
        if not isinstance(images, (list, tuple)):
            images = [images]
        if not any(self.image_token in t for t in texts) and \
                len(images) != len(texts):
            raise ValueError(
                f"Received {len(images)} images for {len(texts)} prompts. "
                f"Each prompt should be associated with an image or list "
                f"of images.")
        out = self.image_processor(images)
        enc = self.tokenizer([self._prompt(t) for t in texts],
                             return_tensors="np", padding=padding,
                             padding_side="left", add_special_tokens=False)
        out["input_ids"] = np.asarray(enc["input_ids"])
        out["attention_mask"] = np.asarray(enc["attention_mask"])
        return out

    def apply_chat_template(self, messages, **kwargs):
        return self.tokenizer.apply_chat_template(messages, **kwargs)


def _paligemma_processor(tokenizer, model, model_path) -> PaliGemmaProcessor:
    """PaliGemmaProcessor for a PaliGemma model: its image token the
    tokenizer's token at the config's `image_token_index`, its count the
    tower's patch grid (or the preprocessor config's
    `image_seq_length`), its images at the tower's size (or the
    preprocessor config's), BOS the tokenizer's."""
    cfg = model.config
    vc = cfg.vision_config
    pc = _preprocessor_config(model_path)
    size = pc.get("size")
    side = (size.get("height", vc.image_size) if isinstance(size, dict)
            else size or vc.image_size)
    kw = {k: pc[k] for k in ("image_mean", "image_std", "rescale_factor")
          if pc.get(k) is not None}
    token = None
    if hasattr(tokenizer, "convert_ids_to_tokens"):
        token = tokenizer.convert_ids_to_tokens(cfg.image_token_index)
    return PaliGemmaProcessor(
        tokenizer, SiglipImageProcessor(side, **kw),
        image_token=token or "<image>",
        num_image_tokens=pc.get("image_seq_length",
                                (vc.image_size // vc.patch_size) ** 2),
        bos_token=getattr(tokenizer, "bos_token", None) or "<bos>")


def clip_image_processor_for(model=None,
                             model_path=None) -> ClipImageProcessor:
    """A checkpoint's CLIP image processor: its preprocessor_config.json's
    size, crop size, mean, std and rescale factor when it has one, else
    its vision config's image size with the CLIP mean and std."""
    vc = getattr(getattr(model, "config", None), "vision_config", None)
    side = getattr(vc, "image_size", 336)
    kw = {"size": side, "crop_size": (side, side)}
    pc = _preprocessor_config(model_path)
    if pc:
        size = pc.get("size")
        if size is not None:
            kw["size"] = (size.get("shortest_edge", side)
                          if isinstance(size, dict) else size)
        crop = pc.get("crop_size")
        if isinstance(crop, dict):
            kw["crop_size"] = (crop["height"], crop["width"])
        elif crop is not None:
            kw["crop_size"] = (crop, crop)
        for k in ("image_mean", "image_std", "rescale_factor"):
            if pc.get(k) is not None:
                kw[k] = pc[k]
    return ClipImageProcessor(**kw)


def _llava_processor(tokenizer, model, model_path) -> LlavaProcessor:
    """LlavaProcessor for a LLaVA model: its image token is the tokenizer's
    token at the config's `image_token_index`, its count the tower's patch
    grid (less CLS under the "default" strategy)."""
    cfg = model.config
    vc = cfg.vision_config
    n = (vc.image_size // vc.patch_size) ** 2
    if cfg.vision_feature_select_strategy != "default":
        n += 1
    token = None
    if hasattr(tokenizer, "convert_ids_to_tokens"):
        token = tokenizer.convert_ids_to_tokens(cfg.image_token_index)
    return LlavaProcessor(tokenizer,
                          clip_image_processor_for(model, model_path),
                          image_token=token or "<image>", num_image_tokens=n)


# families whose processor writes each video frame group with its time
# (transformers' processing_qwen3_vl.py:196-230)
TIMESTAMPED_VIDEO = ("qwen3_vl", "qwen3_vl_moe")


def processor_for(tokenizer, model=None, model_path=None):
    """The numpy processor of `model`'s family around `tokenizer`:
    LlavaProcessor for LLaVA, PaliGemmaProcessor for PaliGemma, else
    Qwen2VLProcessor with the checkpoint's image processor (writing video
    timestamps for Qwen3-VL)."""
    kind = getattr(getattr(model, "config", None), "model_type", "")
    if kind == "llava":
        return _llava_processor(tokenizer, model, model_path)
    if kind == "paligemma":
        return _paligemma_processor(tokenizer, model, model_path)
    return Qwen2VLProcessor(tokenizer, image_processor_for(model, model_path),
                            video_timestamps=kind in TIMESTAMPED_VIDEO)


def load_processor(model_path, model=None, **kwargs):
    """The HF AutoProcessor when transformers can build one with an image
    processor; otherwise the numpy processor of the model's family around
    the checkpoint's tokenizer: LlavaProcessor with the CLIP image
    processor for LLaVA, PaliGemmaProcessor with the SigLIP image
    processor for PaliGemma, else Qwen2VLProcessor with the checkpoint's
    image processor (`image_processor_for`)."""
    model_path = Path(model_path)
    try:
        from transformers import AutoProcessor

        proc = AutoProcessor.from_pretrained(str(model_path), **kwargs)
        if hasattr(proc, "image_processor"):
            return proc
        return processor_for(proc, model, model_path)
    except Exception:  # noqa: BLE001 — no transformers, or no processor files
        pass
    from .tokenizer import load_tokenizer

    return processor_for(load_tokenizer(model_path), model, model_path)


def video_list(videos) -> list:
    """One video (a path, a [T, H, W, 3] array or a list of frames) or a
    list of them -> a list of videos."""
    one = isinstance(videos, (str, Path, np.ndarray)) or (
        isinstance(videos, (list, tuple)) and len(videos) > 0 and (
            hasattr(videos[0], "convert") or (
                isinstance(videos[0], np.ndarray) and videos[0].ndim == 3)))
    return [videos] if one else list(videos)


def prepare_inputs(processor, prompts: Union[str, List[int], np.ndarray],
                   images=None, videos=None, fps=None, **kwargs) -> dict:
    """Normalize user inputs into model arrays (input_ids, attention_mask,
    pixel_values, image_grid_thw; for videos pixel_values_videos,
    video_grid_thw, second_per_grid_ts).  `videos` is one video or a list
    of them, each a path (read by `load_video`, which needs cv2, at `fps`
    frames a second) or its frames; `fps` is a number for all or one per
    video: a path's sampling rate, or the rate of frames given."""
    if kwargs.get("audios") is not None:
        raise NotImplementedError("audio inputs are not ported")
    kwargs.pop("audios", None)
    if isinstance(prompts, np.ndarray):
        return {"input_ids": prompts.reshape(1, -1) if prompts.ndim == 1 else prompts}
    if isinstance(prompts, (list, tuple)) and prompts and isinstance(prompts[0], int):
        return {"input_ids": np.asarray(prompts, np.int64)[None]}
    if images is not None and not isinstance(images, (list, tuple)):
        images = [images]
    if images is not None:
        images = [load_image(im) for im in images]
    if videos is not None:
        videos = video_list(videos)
        rates = fps if isinstance(fps, (list, tuple)) else [fps] * len(videos)
        if len(rates) != len(videos):
            raise ValueError(f"{len(rates)} fps values for {len(videos)} "
                             f"videos")
        loaded = [load_video(v, fps=f) for v, f in zip(videos, rates)]
        videos = [frames for frames, _ in loaded]
        kwargs["fps"] = [rate for _, rate in loaded]
    out = processor(
        text=prompts if isinstance(prompts, list) else [prompts],
        images=images,
        videos=videos,
        padding=True,
        **kwargs,
    )
    result = {}
    for k, v in out.items():
        if hasattr(v, "numpy"):
            v = v.numpy()
        if isinstance(v, (np.ndarray, list)):
            result[k] = np.asarray(v)
    return result

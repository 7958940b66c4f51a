"""Preprocessing: images -> pixel arrays, prompt -> token ids.

Port of mlx_vlm_tpu/utils/processing.py (load_image :24, smart_resize :127,
Qwen2VLImageProcessor :150, Qwen2VLProcessor :273, load_processor :390,
prepare_inputs :420) for images and text; the image processor's patch,
merge and temporal sizes follow the checkpoint (`image_processor_for`).
LLaVA gets a CLIP image processor and a processor that expands each image
token (`ClipImageProcessor`, `LlavaProcessor`, picked by model type in
`load_processor`): the reference has none and gives LLaVA the Qwen2-VL
fallback, whose patch rows the CLIP tower cannot take (ROADMAP Queue 3).
PIL and transformers are imported only inside the functions that use them:
a uint8 [H, W, 3] array whose size already meets the resize rule goes
through without PIL.  Audio and video inputs are not ported.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Union

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


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
        """frames: T uint8 [H, W, 3] frames of one image -> (patches, grid).

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


class Qwen2VLProcessor:
    """Minimal text + image processor mirroring the HF behaviour."""

    image_pad = "<|image_pad|>"

    def __init__(self, tokenizer, image_processor: Qwen2VLImageProcessor):
        self.tokenizer = tokenizer
        self.image_processor = image_processor

    def __call__(self, text=None, images=None, videos=None, padding=True,
                 audio=None, **kw):
        if videos is not None or audio is not None:
            raise NotImplementedError("video and audio inputs are not ported")
        out = {}
        if images is not None:
            out.update(self.image_processor(images))
            merge2 = self.image_processor.merge_size**2
            texts = [text] if isinstance(text, str) else list(text)
            grid_iter = iter(out["image_grid_thw"])
            expanded = []
            for t in texts:
                while self.image_pad in t:
                    n = int(np.prod(next(grid_iter))) // merge2
                    t = t.replace(self.image_pad, "<_IMG_PLACEHOLDER_>" * n, 1)
                expanded.append(t.replace("<_IMG_PLACEHOLDER_>", self.image_pad))
            text = expanded
        enc = self.tokenizer(text, return_tensors="np", padding=padding,
                             padding_side="left")
        out["input_ids"] = np.asarray(enc["input_ids"])
        out["attention_mask"] = np.asarray(enc["attention_mask"])
        return out

    def apply_chat_template(self, messages, **kwargs):
        return self.tokenizer.apply_chat_template(messages, **kwargs)


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
    pre = Path(model_path) / "preprocessor_config.json" if model_path else None
    if pre is not None and pre.exists():
        import json

        with open(pre) as f:
            pc = json.load(f)
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


def clip_image_processor_for(model=None,
                             model_path=None) -> ClipImageProcessor:
    """A checkpoint's CLIP image processor: its preprocessor_config.json's
    size, crop size, mean, std and rescale factor when it has one, else
    its vision config's image size with the CLIP mean and std."""
    vc = getattr(getattr(model, "config", None), "vision_config", None)
    side = getattr(vc, "image_size", 336)
    kw = {"size": side, "crop_size": (side, side)}
    pre = Path(model_path) / "preprocessor_config.json" if model_path else None
    if pre is not None and pre.exists():
        import json

        with open(pre) as f:
            pc = json.load(f)
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


def processor_for(tokenizer, model=None, model_path=None):
    """The numpy processor of `model`'s family around `tokenizer`:
    LlavaProcessor for LLaVA, else Qwen2VLProcessor with the checkpoint's
    image processor."""
    if getattr(getattr(model, "config", None), "model_type", "") == "llava":
        return _llava_processor(tokenizer, model, model_path)
    return Qwen2VLProcessor(tokenizer, image_processor_for(model, model_path))


def load_processor(model_path, model=None, **kwargs):
    """The HF AutoProcessor when transformers can build one with an image
    processor; otherwise the numpy processor of the model's family around
    the checkpoint's tokenizer: LlavaProcessor with the CLIP image
    processor for LLaVA, else Qwen2VLProcessor with the checkpoint's image
    processor (`image_processor_for`)."""
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


def prepare_inputs(processor, prompts: Union[str, List[int], np.ndarray],
                   images=None, videos=None, **kwargs) -> dict:
    """Normalize user inputs into model arrays (input_ids, attention_mask,
    pixel_values, image_grid_thw)."""
    if videos is not None or kwargs.get("audios") is not None:
        raise NotImplementedError("video and audio inputs are not ported")
    kwargs.pop("audios", None)
    if isinstance(prompts, np.ndarray):
        return {"input_ids": prompts.reshape(1, -1) if prompts.ndim == 1 else prompts}
    if isinstance(prompts, (list, tuple)) and prompts and isinstance(prompts[0], int):
        return {"input_ids": np.asarray(prompts, np.int64)[None]}
    if images is not None and not isinstance(images, (list, tuple)):
        images = [images]
    if images is not None:
        images = [load_image(im) for im in images]
    out = processor(
        text=prompts if isinstance(prompts, list) else [prompts],
        images=images,
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

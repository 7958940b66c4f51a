"""Chat templating: per-family media-token message shapes.

Copied from mlx_vlm_tpu/prompt_utils.py (it imports no jax), unchanged
but for `video=`: a video given as frames (a uint8 [T, H, W, 3] array or
a list of frames) is one video, where the reference tests the array's
truth value (which raises) and takes each frame of a list for a video.
Role parity: reference `mlx_vlm/prompt_utils.py` — MODEL_CONFIG:33,
MessageFormatter:238, get_message_json:520, get_chat_template:559,
apply_chat_template:794.

Design: instead of an Enum + formatter-class + method map, each family maps
to a small declarative spec dict (`_FAMILY_FORMATS`) interpreted by one
renderer per shape kind.  The *outputs* (message dicts / placeholder strings)
match the reference contract exactly — they are facts about what each model
family's HF processor expects — while the machinery is our own.

Shape kinds:
  parts        content is a list of {"type": ...} items; images either before
               or after the text item, audio always appended after
  inline       content is a string with the family's literal image token
               stitched before/after the prompt text
  numbered     phi-style "<|image_1|>…<|audio_1|>…" numbered prefixes
  bare         no chat roles at all: the prompt string itself (optionally with
               image tokens attached) is the model input
  text         plain {"role", "content": str} with no media tokens
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, List, Optional, Tuple, Union

# --------------------------------------------------------------------- specs

def _parts(image_first=False, image_type="image", audio=True):
    return {"kind": "parts", "image_first": image_first,
            "image_type": image_type, "audio": audio}


def _inline(token, before=True, repeat=True):
    return {"kind": "inline", "token": token, "before": before,
            "repeat": repeat}


# Family -> message-shape spec (reference MODEL_CONFIG prompt_utils.py:33).
_FAMILY_FORMATS: Dict[str, dict] = {
    # list-of-parts families, image parts after the text
    **dict.fromkeys(
        ["idefics2", "aya_vision", "cohere2_vision", "qwen2_vl", "kimi_vl",
         "kimi_k25", "llama4", "llava", "llava_next", "granite_vision",
         "granite4_vision", "mllama"],
        _parts(image_first=False)),
    # list-of-parts families, image parts before the text
    **dict.fromkeys(
        ["idefics3", "lfm2-vl", "lfm2_vl", "paddleocr_vl", "qwen2_5_vl",
         "zaya1_vl", "qwen3_vl", "qwen3_vl_moe", "qwen3_5", "qwen3_5_moe",
         "qwen3_omni_moe", "mistral3", "glm4v", "glm4v_moe", "glm_ocr",
         "dots_ocr", "smolvlm", "molmo2", "molmo_point", "minimax_m3_vl",
         "locateanything", "hunyuan_vl", "youtu_vl"],
        _parts(image_first=True)),
    # ERNIE wants {"type": "image_url"} parts, before the text
    "ernie4_5_moe_vl": _parts(image_first=True, image_type="image_url"),
    # typed-list families (image parts prepended; assistant content flattens
    # back to a plain string)
    **dict.fromkeys(
        ["internvl_chat", "nemotron_h_nano_omni",
         "nemotronh_nano_omni_reasoning_v3"],
        _parts(image_first=True) | {"assistant_flat": True}),
    **dict.fromkeys(
        ["gemma3n", "gemma4", "gemma4_unified", "diffusion_gemma", "pixtral"],
        _parts(image_first=True) | {"assistant_flat": True}),
    # inline-token families
    "jina_vlm": _inline("<|image|>"),
    "jvlm": _inline("<|image|>"),
    "minicpmo": _inline("<image>"),
    "multi_modality": _inline("<image>"),
    "step3p7": _inline("<im_patch>"),
    "gemma3": _inline("<start_of_image>", before=False),
    **dict.fromkeys(
        ["llava-qwen2", "llava_qwen2", "bunny-llama", "deepseek_vl_v2",
         "deepseekocr", "deepseekocr_2", "phi4-siglip"],
        _inline("<image>\n")),
    "unlimited-ocr": _inline("<image>", repeat=False),
    "minicpmv4_6": _inline("(<image>./</image>)\n"),
    "minicpm": _inline("(<image>./</image>)\n"),  # our MiniCPM-V family
    # numbered-token families
    "phi3_v": {"kind": "numbered"},
    "phi4mm": {"kind": "numbered"},
    # bare-prompt families (no chat roles; media handled by the processor)
    **dict.fromkeys(["florence2", "molmo", "moondream2", "moondream3",
                     "falcon_ocr"], {"kind": "bare"}),
    "paligemma": {"kind": "bare", "suffix_token": "<start_of_image>"},
    # text-only families routed through here
    **dict.fromkeys(["laguna", "nemotron_labs_diffusion", "deepseek_v4",
                     "hrm_text", "minimax_m3"], {"kind": "text"}),
}

# reference prompt_utils.py:115 SINGLE_IMAGE_ONLY_MODELS
_SINGLE_IMAGE_ONLY = {"llava_next", "llava-qwen2", "bunny-llama",
                      "paligemma", "multi_modality", "mllama", "falcon_ocr"}

# families whose templates take {"type": "video", ...} content items
# (reference MessageFormatter.format_message:266)
_VIDEO_FAMILIES = {"qwen2_vl", "qwen2_5_vl", "qwen3_vl", "qwen3_vl_moe",
                   "qwen3_5", "qwen3_5_moe", "qwen3_omni_moe", "gemma4",
                   "gemma4_unified", "diffusion_gemma", "minicpmv4_6",
                   "minimax_m3_vl"}

# families where only the final (unwrapped) message is the model input
# (reference apply_chat_template:935)
_LAST_MESSAGE_ONLY = {"paligemma", "molmo", "florence2", "falcon_ocr"}


def _text_part(text: str) -> dict:
    # both keys: some family templates read .text, others .content
    # (reference MessageBuilder.text_message:200)
    return {"type": "text", "text": text, "content": text}


def _video_parts(prompt: str, kwargs: dict) -> List[dict]:
    from .utils.processing import video_list

    videos = video_list(kwargs["video"])
    fps = kwargs.get("fps", 1)
    fps_list = fps if isinstance(fps, list) else [fps] * len(videos)
    if len(fps_list) != len(videos):
        raise ValueError(
            f"Got {len(fps_list)} fps values for {len(videos)} videos.")
    max_pixels = kwargs.get("max_pixels", 224 * 224)
    parts = [{"type": "video", "video": v, "max_pixels": max_pixels, "fps": f}
             for v, f in zip(videos, fps_list)]
    parts.append(_text_part(prompt))
    return parts


def get_message_json(
    model_type: str,
    prompt: str,
    role: str = "user",
    skip_image_token: bool = False,
    skip_audio_token: bool = False,
    num_images: int = 1,
    num_audios: int = 0,
    **kwargs,
) -> Union[str, Dict[str, Any]]:
    """One chat message with the family's media placeholders.

    Returns a message dict for chat families, or the raw prompt string for
    bare-prompt families (reference get_message_json:520).
    """
    spec = kwargs.pop("_fallback_spec", None) or _FAMILY_FORMATS.get(
        model_type)
    if spec is None:
        raise ValueError(f"Unsupported model: {model_type}")
    if num_images > 1 and model_type in _SINGLE_IMAGE_ONLY:
        raise ValueError(
            f"Model {model_type} does not support multi-image chat. "
            f"Please only use 1 image.")

    video = kwargs.get("video")
    if model_type in _VIDEO_FAMILIES and video is not None and not (
            isinstance(video, (list, tuple)) and not video):
        return {"role": role, "content": _video_parts(prompt, kwargs)}

    want_images = (role == "user" and not skip_image_token and num_images > 0)
    want_audio = (role == "user" and not skip_audio_token and num_audios > 0)
    kind = spec["kind"]

    if kind == "parts":
        content: List[dict] = [_text_part(prompt)]
        if want_images:
            imgs = [{"type": spec["image_type"]}] * num_images
            content = imgs + content if spec["image_first"] else content + imgs
        if want_audio and spec.get("audio", True):
            content = content + [{"type": "audio"}] * num_audios
        if role == "assistant" and spec.get("assistant_flat"):
            return {"role": role, "content": prompt}
        return {"role": role, "content": content}

    if kind == "inline":
        body = prompt
        if want_images:
            tok = spec["token"] * (num_images if spec["repeat"] else 1)
            body = tok + body if spec["before"] else body + tok
        if want_audio:
            body = "".join(f"<|audio_{i + 1}|>"
                           for i in range(num_audios)) + body
        return {"role": role, "content": body}

    if kind == "numbered":
        body = prompt
        if role == "user":
            prefix = ""
            if not skip_image_token and num_images > 0:
                prefix += "".join(f"<|image_{i + 1}|>"
                                  for i in range(num_images))
            if not skip_audio_token and num_audios > 0:
                prefix += "".join(f"<|audio_{i + 1}|>"
                                  for i in range(num_audios))
            body = prefix + body
        return {"role": role, "content": body}

    if kind == "bare":
        suffix = spec.get("suffix_token")
        if suffix and want_images:
            return prompt + suffix * num_images
        return prompt

    # kind == "text"
    return {"role": role, "content": prompt}


# ----------------------------------------------------------------- utilities

def extract_text_from_content(content: Any) -> str:
    """Text parts only — keeps base64 image payloads out of the tokenizer
    (reference extract_text_from_content:123)."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        parts = []
        for item in content:
            if isinstance(item, dict) and item.get("type") in ("text",
                                                               "input_text"):
                text = item.get("text", "") or item.get("content", "")
                if text:
                    parts.append(text)
        return " ".join(parts).strip()
    return str(content) if content else ""


def _role_content(item: Any) -> Optional[Tuple[str, Any]]:
    if isinstance(item, dict):
        return item.get("role", "user"), item.get("content")
    if hasattr(item, "role") and hasattr(item, "content"):
        return getattr(item, "role", "user"), getattr(item, "content", "")
    return None


def _normalize_tool_args(message: Dict[str, Any]) -> Dict[str, Any]:
    """OpenAI sends tool arguments JSON-encoded; Jinja templates want dicts
    (reference _normalize_tool_call_arguments:171)."""
    out = dict(message)
    calls = out.get("tool_calls")
    if calls is None:
        return out
    fixed = []
    for call in calls:
        call = dict(call) if isinstance(call, dict) else call
        if isinstance(call, dict) and "function" in call:
            fn = dict(call["function"])
            if isinstance(fn.get("arguments"), str):
                try:
                    fn["arguments"] = json.loads(fn["arguments"])
                except (json.JSONDecodeError, TypeError):
                    fn["arguments"] = {}
            call["function"] = fn
        fixed.append(call)
    out["tool_calls"] = fixed
    return out


def _media_token(processor, attr: str, default: str) -> str:
    for owner in (processor, getattr(processor, "tokenizer", None)):
        tok = getattr(owner, attr, None)
        if isinstance(tok, str) and tok:
            return tok
    return default


def _flatten_parts(content: Any, image_token: str, video_token: str,
                   audio_token: str) -> str:
    """Render a parts-list content to a single string, stitching a space
    between a media marker and following prose (reference
    _flatten_content:598)."""
    if isinstance(content, str):
        return content
    if isinstance(content, dict):
        return str(content.get("text", "") or content.get("content", "") or "")
    if not isinstance(content, list):
        return str(content) if content is not None else ""
    markers = {image_token, video_token, audio_token, "<audio>", "<video>"}
    parts: List[str] = []
    for item in content:
        if isinstance(item, dict):
            t = item.get("type", "")
            if t in ("image", "image_url", "input_image"):
                parts.append(image_token)
            elif t in ("video", "input_video", "video_url"):
                parts.append(video_token)
            elif t in ("audio", "input_audio"):
                parts.append(audio_token)
            else:
                text = item.get("text", "") or item.get("content", "")
                if text:
                    parts.append(str(text))
        elif item is not None:
            parts.append(str(item))
    stitched: List[str] = []
    prev_marker = False
    for p in parts:
        if not p:
            continue
        is_marker = p in markers
        if prev_marker and not is_marker and not p[0].isspace():
            stitched.append(" ")
        stitched.append(p)
        prev_marker = is_marker
    return "".join(stitched).strip()


def _chatml_fallback(processor, messages, add_generation_prompt: bool) -> str:
    """No-template terminal fallback: ChatML with media markers.

    The reference renders "Role: content" lines here; our test fleet's tiny
    checkpoints are ChatML/Qwen-shaped, so we render ChatML and default the
    image marker to the Qwen vision triplet when the processor does not
    declare one.
    """
    image_token = _media_token(processor, "image_token",
                               "<|vision_start|><|image_pad|><|vision_end|>")
    video_token = _media_token(processor, "video_token",
                               "<|vision_start|><|video_pad|><|vision_end|>")
    audio_token = _media_token(processor, "audio_token", "<|audio_pad|>")
    out = []
    for m in messages:
        if isinstance(m, str):
            m = {"role": "user", "content": m}
        body = _flatten_parts(m.get("content", ""), image_token, video_token,
                              audio_token)
        out.append(f"<|im_start|>{m.get('role', 'user')}\n{body}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _accepts_kw(fn, name: str) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters or any(
        p.kind == inspect.Parameter.VAR_KEYWORD
        for p in sig.parameters.values())


def _find_template_owner(processor, override) -> Optional[Any]:
    """The object whose apply_chat_template has a real template to run
    (reference get_chat_template:735)."""
    candidates = [processor, getattr(processor, "tokenizer", None)]
    for owner in candidates:
        if owner is None or not hasattr(owner, "apply_chat_template"):
            continue
        if override is not None or getattr(owner, "chat_template",
                                           None) is not None:
            return owner
    return None


def get_chat_template(
    processor,
    messages: List[Any],
    add_generation_prompt: bool,
    tokenize: bool = False,
    **kwargs,
) -> Any:
    """Run the processor/tokenizer Jinja template, or fall back to ChatML
    (reference get_chat_template:559)."""
    override = kwargs.get("chat_template")
    owner = _find_template_owner(processor, override)
    if owner is None:
        return _chatml_fallback(processor, messages, add_generation_prompt)
    template_kwargs = dict(kwargs)
    template_kwargs.pop("_fallback_spec", None)  # internal routing only
    if ("enable_thinking" not in template_kwargs
            and _accepts_kw(owner.apply_chat_template, "enable_thinking")):
        template_kwargs["enable_thinking"] = False
    try:
        return owner.apply_chat_template(
            messages, tokenize=tokenize,
            add_generation_prompt=add_generation_prompt, **template_kwargs)
    except Exception:  # noqa: BLE001 — missing/broken template
        if override is not None:
            raise
        return _chatml_fallback(processor, messages, add_generation_prompt)


# ------------------------------------------------------------ main entrypoint

def apply_chat_template(
    processor,
    config: Union[Dict[str, Any], Any],
    prompt: Union[str, Dict[str, Any], List[Any]],
    add_generation_prompt: bool = True,
    return_messages: bool = False,
    num_images: int = 1,
    num_audios: int = 0,
    **kwargs,
) -> Union[List[Dict[str, Any]], str, Any]:
    """Family-aware chat templating (reference apply_chat_template:794).

    `prompt` may be a string, one message dict, or a list of messages
    (strings or dicts).  Media placeholder tokens are attached to the last
    user message per the model family's shape; tool-calling messages pass
    through with their arguments JSON-decoded.
    """
    if not isinstance(config, dict):
        config = getattr(config, "__dict__", {}) or {}
    model_type = config.get("model_type", "")

    if model_type not in _FAMILY_FORMATS and (num_images > 0
                                              or num_audios > 0):
        # Unknown-but-multimodal: use the generic parts shape rather than
        # silently dropping the media placeholders.  Passed through as a
        # LOCAL fallback — registering it in the module-global
        # _FAMILY_FORMATS would permanently pollute the registry (an
        # unknown model_type seen once would resolve forever after).
        kwargs["_fallback_spec"] = _parts(image_first=False)

    if (model_type not in _FAMILY_FORMATS
            and "_fallback_spec" not in kwargs):
        # text-only model: strip media parts, keep roles/tool metadata
        if isinstance(prompt, str):
            messages = [{"role": "user", "content": prompt}]
        elif isinstance(prompt, dict):
            msg = dict(prompt)
            if msg.get("role") != "tool" and "tool_calls" not in msg:
                msg["content"] = extract_text_from_content(
                    msg.get("content", ""))
            messages = [_normalize_tool_args(msg)]
        elif isinstance(prompt, list):
            messages = []
            for item in prompt:
                if isinstance(item, str):
                    messages.append({"role": "user", "content": item})
                    continue
                rc = _role_content(item)
                if rc is None:
                    continue
                role, content = rc
                msg = dict(item) if isinstance(item, dict) else {"role": role}
                if role != "tool" and "tool_calls" not in msg:
                    msg["content"] = extract_text_from_content(content)
                messages.append(_normalize_tool_args(msg))
        else:
            messages = [{"role": "user", "content": str(prompt)}]
        if return_messages:
            return messages
        return get_chat_template(processor, messages, add_generation_prompt,
                                 **kwargs)

    messages = []
    if isinstance(prompt, str):
        messages.append(get_message_json(
            model_type, prompt, num_images=num_images, num_audios=num_audios,
            **kwargs))
    elif isinstance(prompt, dict):
        role = prompt.get("role", "user")
        if "tool_calls" in prompt or "tool_call_id" in prompt or role == "tool":
            messages.append(_normalize_tool_args(prompt))
        else:
            messages.append(get_message_json(
                model_type, extract_text_from_content(prompt["content"]),
                role, num_images=num_images, num_audios=num_audios, **kwargs))
    elif isinstance(prompt, list):
        # media tokens go on the LAST user message only
        last_user = -1
        for i, p in enumerate(prompt):
            if isinstance(p, str):
                last_user = i
            elif (rc := _role_content(p)) is not None and rc[0] not in (
                    "system", "assistant", "tool"):
                last_user = i
        for i, p in enumerate(prompt):
            if isinstance(p, str):
                messages.append(get_message_json(
                    model_type, p,
                    skip_image_token=i != last_user,
                    skip_audio_token=i != last_user,
                    num_images=num_images, num_audios=num_audios, **kwargs))
                continue
            rc = _role_content(p)
            if rc is None:
                continue
            role, content = rc
            if isinstance(p, dict) and ("tool_calls" in p
                                        or "tool_call_id" in p
                                        or role == "tool"):
                messages.append(_normalize_tool_args(p))
            else:
                skip = i != last_user or role in ("system", "assistant")
                messages.append(get_message_json(
                    model_type, extract_text_from_content(content), role,
                    skip_image_token=skip, skip_audio_token=skip,
                    num_images=num_images, num_audios=num_audios, **kwargs))
    else:
        messages.append(get_message_json(
            model_type, str(prompt), num_images=num_images,
            num_audios=num_audios, **kwargs))

    if return_messages:
        return messages
    if model_type in _LAST_MESSAGE_ONLY:
        return messages[-1]
    return get_chat_template(processor, messages, add_generation_prompt,
                             **kwargs)

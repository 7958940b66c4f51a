"""`python -m mlx_vlm_tpu_torch generate`: one prompt, streamed.

Port of mlx_vlm_tpu/generate/cli.py, with the reference's flags and
`--device` (the model loads onto the card unless `--device cpu` is
given).  `--video` takes paths (read with cv2) and `--fps` the rate to
sample them at; the prompt gets a video part for each, after the images'
parts (the reference's prompt takes none, so its videos find no token).
"""

from __future__ import annotations

import argparse


def parse_arguments(argv=None):
    p = argparse.ArgumentParser("mlx_vlm_tpu_torch generate")
    p.add_argument("--model", required=True)
    p.add_argument("--prompt", default="Describe this image.")
    p.add_argument("--image", nargs="*", default=None)
    p.add_argument("--video", nargs="*", default=None)
    p.add_argument("--fps", type=float, default=None,
                   help="frames a second to sample each --video at")
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--temperature", "--temp", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=-1)
    p.add_argument("--min-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--prefill-step-size", type=int, default=512)
    p.add_argument("--chat-template-args", default=None)
    p.add_argument("--verbose", action="store_true", default=True)
    p.add_argument("--device", default="cuda",
                   help="device to load the model onto")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    from ..prompt_utils import (apply_chat_template, get_chat_template,
                                get_message_json)
    from ..utils.loader import load
    from .dispatch import generate

    model, processor = load(args.model, device=args.device)
    n_images = len(args.image) if args.image else 0
    config = getattr(model, "config_dict", {})
    message = None
    if args.video:  # a video family's message: video parts, then the text
        message = get_message_json(config.get("model_type", ""), args.prompt,
                                   video=args.video, fps=args.fps or 1)
    if isinstance(message, dict) and isinstance(message["content"], list):
        message["content"][:0] = [{"type": "image"}] * n_images
        prompt = get_chat_template(processor, [message], True)
    else:  # no video, or a model that refuses it in generate
        prompt = apply_chat_template(processor, config, args.prompt,
                                     num_images=max(n_images, 0))
    generate(
        model,
        processor,
        prompt,
        image=args.image,
        video=args.video,
        fps=args.fps,
        max_tokens=args.max_tokens,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        min_p=args.min_p,
        seed=args.seed,
        repetition_penalty=args.repetition_penalty,
        prefill_step_size=args.prefill_step_size,
        verbose=True,
    )


if __name__ == "__main__":
    main()

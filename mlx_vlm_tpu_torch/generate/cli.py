"""`python -m mlx_vlm_tpu_torch generate`: one prompt, streamed.

Port of mlx_vlm_tpu/generate/cli.py, with the reference's flags and
`--device` (the model loads onto the card unless `--device cpu` is
given).  `--video` is taken, and stream_generate refuses it.
"""

from __future__ import annotations

import argparse


def parse_arguments(argv=None):
    p = argparse.ArgumentParser("mlx_vlm_tpu_torch generate")
    p.add_argument("--model", required=True)
    p.add_argument("--prompt", default="Describe this image.")
    p.add_argument("--image", nargs="*", default=None)
    p.add_argument("--video", nargs="*", default=None)
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
    from ..prompt_utils import apply_chat_template
    from ..utils.loader import load
    from .dispatch import generate

    model, processor = load(args.model, device=args.device)
    n_images = len(args.image) if args.image else 0
    prompt = apply_chat_template(
        processor, getattr(model, "config_dict", {}), args.prompt,
        num_images=max(n_images, 0),
    )
    generate(
        model,
        processor,
        prompt,
        image=args.image,
        video=args.video,
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

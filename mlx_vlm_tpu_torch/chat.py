"""`python -m mlx_vlm_tpu_torch chat`: a terminal chat.

Port of mlx_vlm_tpu/chat.py: a REPL with `/image <path>` (the image goes
with the next message), `/reset` (clears the conversation and the prefix
cache) and `/exit`; each turn runs stream_generate over the whole
conversation with a vision-feature cache, and with `--apc` a prefix cache
(apc.APCManager), so that a turn prefills only what the last one did not.
The model loads onto the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("mlx_vlm_tpu_torch chat")
    p.add_argument("--model", required=True)
    p.add_argument("--max-tokens", type=int, default=512)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--apc", action="store_true", help="enable prefix caching")
    p.add_argument("--device", default="cuda",
                   help="device to load the model onto")
    args = p.parse_args(argv)

    from .apc import APCManager
    from .generate.dispatch import stream_generate
    from .prompt_utils import apply_chat_template
    from .utils.loader import load
    from .vision_cache import VisionFeatureCache

    model, processor = load(args.model, device=args.device)
    apc = APCManager() if args.apc else None
    vcache = VisionFeatureCache()
    messages = []
    images = []

    print("Chat ready. Commands: /image <path>, /reset, /exit")
    while True:
        try:
            line = input("\n>> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        if line in ("/exit", "/quit", "q"):
            break
        if line == "/reset":
            messages, images = [], []
            if apc:
                apc.reset()
            print("(context cleared)")
            continue
        if line.startswith("/image "):
            images.append(line.split(" ", 1)[1].strip())
            print(f"(image added: {images[-1]})")
            continue

        n_new_images = len(images)
        messages.append(
            {
                "role": "user",
                "content": (
                    [{"type": "image"}] * n_new_images
                    + [{"type": "text", "text": line}]
                ),
            }
        )
        prompt = apply_chat_template(
            processor, getattr(model, "config_dict", {}), messages,
            num_images=n_new_images,
        )
        reply = []
        for res in stream_generate(
            model, processor, prompt,
            image=images or None,
            max_tokens=args.max_tokens,
            temperature=args.temperature,
            apc=apc,
            vision_cache=vcache,
        ):
            print(res.text, end="", flush=True)
            reply.append(res.text)
        print()
        messages.append({"role": "assistant", "content": "".join(reply)})
        images = []


if __name__ == "__main__":
    main()

"""`python -m mlx_vlm_tpu_torch server` — port of mlx_vlm_tpu/server/cli.py.

The reference's flags.  The model loads onto the card, and so does the
drafter that `--draft-model` names: the server then decodes
speculatively, `--num-draft-tokens` drafted a round.  `--image-model` and
`--detect-model` name features that are not ported, and `--extra-model`
one that the server does not serve yet: they raise NotImplementedError
before any load (server/app.py `serve`).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None):
    p = argparse.ArgumentParser("mlx_vlm_tpu_torch.server")
    p.add_argument("--model", required=True, help="model path or HF repo")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-concurrency", type=int, default=8,
                   help="continuous-batching slots")
    p.add_argument("--max-context", type=int, default=4096)
    p.add_argument("--api-key", default=None)
    p.add_argument("--draft-model", default=None,
                   help="small same-tokenizer model for speculative decoding "
                        "of greedy requests")
    p.add_argument("--num-draft-tokens", type=int, default=4)
    p.add_argument("--extra-model", action="append", default=[],
                   metavar="NAME=PATH",
                   help="additional model for the hot-swap registry "
                        "(repeatable); requests select it via 'model'")
    p.add_argument("--max-models", type=int, default=2,
                   help="max concurrently-loaded registry models")
    p.add_argument("--image-model", default=None,
                   help="Flux2-class checkpoint dir enabling "
                        "/v1/images/generations and /v1/images/edits")
    p.add_argument("--detect-model", default=None,
                   help="detection/segmentation checkpoint "
                        "(sam3/rfdetr/rt_detr_v2) enabling /v1/detection")
    p.add_argument("--kv-bits", type=int, default=None, choices=(4, 8),
                   help="serve with quantized KV caches (fused "
                        "integer-domain batch attention; 2-4x less KV "
                        "decode traffic at long contexts)")
    p.add_argument("--kv-group-size", type=int, default=64)
    p.add_argument("--log-level", default="INFO")
    args = p.parse_args(argv)
    logging.basicConfig(level=args.log_level)

    extra = {}
    for spec in args.extra_model:
        name, _, path = spec.partition("=")
        if not path:
            p.error(f"--extra-model expects NAME=PATH, got {spec!r}")
        extra[name] = path

    from .app import serve

    serve(
        args.model, host=args.host, port=args.port,
        num_slots=args.max_concurrency, capacity=args.max_context,
        api_key=args.api_key,
        draft_model_path=args.draft_model, num_draft=args.num_draft_tokens,
        extra_models=extra or None, max_models=args.max_models,
        image_model_path=args.image_model,
        detect_model_path=args.detect_model,
        kv_bits=args.kv_bits, kv_group_size=args.kv_group_size,
    )


if __name__ == "__main__":
    main()

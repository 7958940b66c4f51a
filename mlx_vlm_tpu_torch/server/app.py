"""HTTP server (stdlib ThreadingHTTPServer; each request handler blocks
only on its own token queue).

Port of mlx_vlm_tpu/server/app.py (ServerState :24, make_handler :45,
create_server :264, serve :303), with the reference's routes:
/v1/chat/completions, /v1/messages (+count_tokens), /v1/responses (+
retrieve, delete, input_items), /v1/models, /health, /metrics,
/v1/cache/stats and /v1/cache/reset, the web page and the API-key check.
The handler threads do no device work: they normalize, template and
queue, and the engine's owner thread runs everything on the card
(server/engine.py).  The audio routes answer as the reference's do for a
model with no audio tower (server/audio.py); the image-generation and
detection routes answer 400 as the reference's do with no such model
loaded.  `create_server` builds the APC manager from the environment
(APC_ENABLED, apc.py `from_env`) unless the caller passes `apc`; the
cache routes serve it.  A draft model (`serve(draft_model_path=)`,
`create_server(draft_model=)`) serves speculatively: `serve` loads it
before the owner thread starts, and the engine admits its rows there.
Image generation and detection models are not ported, and extra models
for the
hot-swap registry (server/registry.py) are not served: the registry
loads a model on a handler thread and gives it an owner thread of its
own, whose CUDA work could land inside the first owner's graph capture.
Asking for any of these raises NotImplementedError before any load.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..version import __version__
from .engine import ResponseGenerator

logger = logging.getLogger("mlx_vlm_tpu_torch.server")


class ServerState:
    def __init__(self, model_name: str, generator: ResponseGenerator,
                 api_key: Optional[str] = None, registry=None):
        self.model_name = model_name
        self.generator = generator
        self.api_key = api_key or os.environ.get("MLX_VLM_SERVER_API_KEY")
        self.registry = registry

    def resolve(self, model: Optional[str]) -> tuple:
        """(generator, model_name) for a request's `model` field — the
        default generator unless the hot-swap registry knows the name
        (reference runtime.py get_cached_model)."""
        if self.registry is not None and model and model != self.model_name:
            entry = self.registry.get(model)
            if entry is not None:
                return entry.generator, model
        return self.generator, self.model_name


def make_handler(state: ServerState):
    from . import anthropic as anthropic_routes
    from . import openai as openai_routes

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = f"mlx-vlm-tpu/{__version__}"

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s - %s", self.address_string(), fmt % args)

        # ---------------------------------------------------------- helpers
        def send_json(self, obj, status: int = 200):
            payload = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def start_sse(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def send_sse(self, obj):
            self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
            self.wfile.flush()

        def send_sse_event(self, event: str, obj):
            self.wfile.write(
                f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode()
            )
            self.wfile.flush()

        def send_sse_done(self):
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            return json.loads(raw or b"{}")

        def _auth_ok(self) -> bool:
            if not state.api_key:
                return True
            auth = self.headers.get("Authorization", "")
            key = auth.removeprefix("Bearer ").strip() or self.headers.get(
                "x-api-key", ""
            )
            return key == state.api_key

        # ------------------------------------------------------------ routes
        def do_DELETE(self):  # noqa: N802
            if self.path.startswith("/v1/responses/"):
                from . import responses as responses_routes

                responses_routes.delete_response(
                    self, self.path.rstrip("/").split("/")[-1]
                )
            else:
                self.send_json({"error": {"message": "not found"}}, 404)

        def do_GET(self):  # noqa: N802
            if self.path in ("/", "/chat"):
                from .webui import PAGE

                payload = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
            elif self.path == "/health":
                self.send_json({"status": "ok", "model": state.model_name})
            elif self.path == "/metrics":
                from ..utils.profiling import global_phases

                snap = state.generator.metrics.snapshot()
                snap["phases"] = global_phases().snapshot()
                self.send_json(snap)
            elif self.path in ("/v1/models", "/models"):
                names = [state.model_name]
                if state.registry is not None:
                    names += [n for n in state.registry.names()
                              if n != state.model_name]
                self.send_json({
                    "object": "list",
                    "data": [{
                        "id": n,
                        "object": "model",
                        "owned_by": "mlx_vlm_tpu",
                    } for n in names],
                })
            elif self.path == "/v1/cache/stats":
                apc = getattr(state.generator, "apc", None)
                self.send_json(apc.snapshot() if apc else {"enabled": False})
            elif self.path.startswith("/v1/responses/"):
                from . import responses as responses_routes

                parts = self.path.rstrip("/").split("/")
                if parts[-1] == "input_items":
                    responses_routes.list_input_items(self, parts[-2])
                else:
                    responses_routes.retrieve_response(self, parts[-1])
            else:
                self.send_json({"error": {"message": "not found"}}, 404)

        def do_POST(self):  # noqa: N802
            if self.path in ("/v1/audio/transcriptions", "/audio/transcriptions",
                             "/v1/audio/translations", "/audio/translations"):
                from . import audio as audio_routes

                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    raw = self.rfile.read(length)
                    gen, _ = state.resolve(None)
                    audio_routes.transcription_endpoint(
                        self, raw, self.headers.get("Content-Type", ""),
                        gen, translate="translations" in self.path,
                    )
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    logger.exception("audio request failed")
                    try:
                        self.send_json({"error": {"message": str(e)}}, 400)
                    except Exception:  # noqa: BLE001
                        pass
                return
            try:
                body = self._body()
            except Exception as e:  # noqa: BLE001
                self.send_json(
                    {"error": {"message": f"invalid JSON body: {e}"}}, 400
                )
                return
            try:
                if self.path == "/v1/responses":
                    from . import responses as responses_routes

                    gen, name = state.resolve(body.get("model"))
                    responses_routes.create_response(self, body, gen, name)
                elif self.path == "/v1/chat/completions":
                    gen, name = state.resolve(body.get("model"))
                    openai_routes.chat_completion(self, body, gen, name)
                elif self.path == "/v1/messages":
                    if not self._auth_ok():
                        self.send_json({"error": {"message": "unauthorized"}}, 401)
                        return
                    gen, name = state.resolve(body.get("model"))
                    anthropic_routes.messages_endpoint(self, body, gen, name)
                elif self.path == "/v1/messages/count_tokens":
                    gen, name = state.resolve(body.get("model"))
                    anthropic_routes.count_tokens(self, body, gen, name)
                elif self.path in ("/v1/audio/speech", "/audio/speech"):
                    from . import audio as audio_routes

                    gen, _ = state.resolve(body.get("model"))
                    audio_routes.speech_endpoint(self, body, gen)
                elif self.path in ("/v1/images/generations",
                                   "/images/generations",
                                   "/v1/images/edits", "/images/edits"):
                    self.send_json({"error": {"message":
                                    "no image model loaded "
                                    "(start with --image-model)"}}, 400)
                elif self.path in ("/v1/detection", "/detection",
                                   "/v1/detect"):
                    self.send_json({"error": {"message":
                                    "no detection model loaded "
                                    "(start with --detect-model)"}}, 400)
                elif self.path == "/v1/cache/reset":
                    apc = getattr(state.generator, "apc", None)
                    if apc:
                        apc.reset()
                    self.send_json({"status": "ok"})
                else:
                    self.send_json({"error": {"message": "not found"}}, 404)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                # schemas.ValidationError is a ValueError
                status = 400 if isinstance(e, ValueError) else 500
                etype = "invalid_request_error" if status == 400 else "server_error"
                if status == 500:
                    logger.exception("request failed")
                try:
                    self.send_json(
                        {"error": {"message": str(e), "type": etype}}, status
                    )
                except Exception:  # noqa: BLE001
                    pass

    return Handler


def create_server(
    model, processor, model_name: str = "local-model",
    host: str = "0.0.0.0", port: int = 8080,
    num_slots: int = 8, capacity: int = 4096,
    api_key: Optional[str] = None,
    extra_models: Optional[dict] = None,  # name -> path: refused
    max_models: int = 2,  # the registry's bound: unused while it is refused
    image_service=None,
    detection_service=None,
    **engine_kwargs,
) -> ThreadingHTTPServer:
    if image_service is not None or detection_service is not None:
        raise NotImplementedError(
            "image generation and detection services are not ported "
            "(ROADMAP Queue 1 item 5)")
    _refuse_extra_models(extra_models)
    if "apc" not in engine_kwargs:
        from .. import apc as apc_mod

        engine_kwargs["apc"] = apc_mod.from_env()
    if "vision_cache" not in engine_kwargs:
        from ..vision_cache import VisionFeatureCache

        engine_kwargs["vision_cache"] = VisionFeatureCache()
    generator = ResponseGenerator(
        model, processor, num_slots=num_slots, capacity=capacity, **engine_kwargs
    )
    state = ServerState(model_name, generator, api_key)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.state = state
    return httpd


def _refuse_extra_models(extra_models) -> None:
    if extra_models:
        raise NotImplementedError(
            "extra models (--extra-model) are not served: the hot-swap "
            "registry would load them and run their engines off the one "
            "thread that owns the card (ROADMAP Queue 1 item 5)")


def serve(model_path: str, host="0.0.0.0", port=8080,
          draft_model_path: str | None = None,
          image_model_path: str | None = None,
          detect_model_path: str | None = None, **kwargs):
    """Load `model_path` (onto the card), and the drafter at
    `draft_model_path` when one is named, on this thread before the
    server's owner thread starts, and serve until interrupted."""
    for flag, value in (("--image-model", image_model_path),
                        ("--detect-model", detect_model_path)):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported (ROADMAP Queue 1 item 5)")
    _refuse_extra_models(kwargs.get("extra_models"))
    from ..utils.loader import load

    model, processor = load(model_path)
    if draft_model_path:
        kwargs["draft_model"], _ = load(draft_model_path)
    httpd = create_server(model, processor, model_name=model_path,
                          host=host, port=port, **kwargs)
    logger.info("serving %s on %s:%d", model_path, host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.state.generator.shutdown()

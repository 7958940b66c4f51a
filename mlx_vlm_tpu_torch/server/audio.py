"""Audio routes for a model with no audio tower and no speech head.

The reference's mlx_vlm_tpu/server/audio.py serves /v1/audio/transcriptions,
/v1/audio/translations and /v1/audio/speech through an omni model's audio
tower and talker.  No model the port loads has either (audio models,
`load_audio` and `log_mel_spectrogram` are not ported: ROADMAP Queue 1
item 5), so these routes answer as the reference's do for such a model:
400 with the reference's message (transcription_endpoint :133 through
`_transcribe_prompt` :100, speech_endpoint :196).
"""

from __future__ import annotations

from email.parser import BytesParser
from email.policy import HTTP

NO_AUDIO_INPUT = ("loaded model does not accept audio input "
                  "(no audio placeholder token / audio tower)")
NO_SPEECH_HEAD = ("loaded model has no speech head; load an omni model with "
                  "a talker for TTS")


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Parse multipart/form-data into {name: bytes | (filename, bytes)}
    (reference :33)."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
    )
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data body")
    fields: dict = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True)
        filename = part.get_filename()
        fields[name] = (filename, payload) if filename else payload
    return fields


def transcription_endpoint(handler, body: bytes, content_type: str,
                           generator, *, translate: bool = False):
    """POST /v1/audio/transcriptions | /v1/audio/translations: a body that
    is not multipart raises ValueError (400), an upload-less one and any
    other answer 400."""
    upload = parse_multipart(body, content_type).get("file")
    if not isinstance(upload, tuple):
        handler.send_json(
            {"error": {"message": "missing file upload"}}, 400)
        return
    raise ValueError(NO_AUDIO_INPUT)


def speech_endpoint(handler, body: dict, generator):
    """POST /v1/audio/speech: 400, for a missing input or for the model's
    missing speech head."""
    if not body.get("input", ""):
        handler.send_json({"error": {"message": "missing input"}}, 400)
        return
    handler.send_json({"error": {"message": NO_SPEECH_HEAD}}, 400)

"""`python -m mlx_vlm_tpu_torch <command>` — port of mlx_vlm_tpu/__main__.py.

The port has the `generate`, `server` and `chat` commands.  Any other
command, the reference's included, gets the reference's usage exit (code
2) and a line naming what is ported.
"""

import importlib
import sys

_COMMANDS = {
    "generate": "mlx_vlm_tpu_torch.generate.cli",
    "server": "mlx_vlm_tpu_torch.server.cli",
    "chat": "mlx_vlm_tpu_torch.chat",
}
# the reference's commands that the port does not have yet
_NOT_PORTED = ("convert", "lora", "detect", "sft")


def main():
    if len(sys.argv) < 2 or sys.argv[1] not in _COMMANDS:
        print(f"usage: python -m mlx_vlm_tpu_torch {{{','.join(_COMMANDS)}}} "
              f"...")
        print(f"ported: {', '.join(_COMMANDS)}; not ported yet: "
              f"{', '.join(_NOT_PORTED)}")
        raise SystemExit(2)
    cmd = sys.argv.pop(1)
    mod = importlib.import_module(_COMMANDS[cmd])
    mod.main()


if __name__ == "__main__":
    main()

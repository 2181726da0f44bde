"""CLI root of the port: ``accelerate-tpu-torch <command>`` (port of
``accelerate_tpu/commands/accelerate_cli.py``; ``serve`` and ``route`` so
far)."""

from __future__ import annotations

import argparse
import sys

from . import route, serve


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "accelerate-tpu-torch",
        usage="accelerate-tpu-torch <command> [<args>]",
        allow_abbrev=False,
    )
    subparsers = parser.add_subparsers(dest="command")
    for module in (serve, route):
        module.add_parser(subparsers)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return 1
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())

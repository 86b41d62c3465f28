"""absl-style boolean flags for the argparse CLIs (train, eval):
``--name``, ``--name=true|false`` and ``--noname``, as the JAX package's
absl flags take them."""
from __future__ import annotations

import argparse

_TRUE = ('1', 'true', 't', 'yes', 'y')
_FALSE = ('0', 'false', 'f', 'no', 'n')


def _parse_bool(text: str) -> bool:
    low = text.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f'not a boolean: {text!r}')


def add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
                  help: str) -> None:
    parser.add_argument(f'--{name}', nargs='?', const=True, default=default,
                        type=_parse_bool, metavar='BOOL',
                        help=f'{help} (default {default}).')
    parser.add_argument(f'--no{name}', dest=name, action='store_false',
                        help=argparse.SUPPRESS)

"""``python -m troute_torch -f config.yaml`` — CLI entry point (reference
parity: ``python -m nwm_routing -f -V4 config.yaml``).

Version dispatch mirrors the reference (``__main__.py:2197-2223``): v4 is
the default, ``-V 3`` runs v3-era configs through the same path, and
``--async`` runs the async-pipelined variant (``cli.main_v03_async``).
``-V 2`` is rejected with an explanation: the reference's ``main_v02``
is dead code there (it calls ``_input_handler_v02``, which is not
defined anywhere in the reference source, and the version dispatch never
invokes it).
"""

import argparse
import asyncio
import logging
import sys

from troute_torch.cli import main_v03_async, main_v04

if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    v_parser = argparse.ArgumentParser(add_help=False)
    v_parser.add_argument("-V", "--input-version", type=int, default=4,
                          choices=[2, 3, 4])
    v_parser.add_argument("--async", dest="async_loop", action="store_true")
    v_args, rest = v_parser.parse_known_args(sys.argv[1:])
    if v_args.input_version == 2:
        sys.exit("v02 input format is not supported: the reference's "
                 "main_v02 is itself non-functional (undefined "
                 "_input_handler_v02); use -V 3 for v3-era YAMLs")
    if v_args.input_version == 3 and "-V3" not in rest:
        rest = ["-V3"] + rest
    if v_args.async_loop:
        asyncio.run(main_v03_async(rest))
    else:
        main_v04(rest)

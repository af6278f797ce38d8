"""Command-line entry point.

Parity with the reference CLI (``pyCuSDR/pyCuSDR.py:349-388``):
``python -m pycusdr_tpu -c config.json -v[vv]``.
"""

import argparse
import sys

from pycusdr_tpu import __version__


def build_argparser():
    p = argparse.ArgumentParser(
        prog="pycusdr_tpu",
        description="Software-defined-radio modem for satellite ground stations",
    )
    p.add_argument("-c", "--configFile", required=True, help="modular JSON config file")
    p.add_argument("-v", action="count", default=0, dest="v",
                   help="increase verbosity (-v, -vv, -vvv)")
    p.add_argument("-V", "--version", action="version", version=__version__)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    sdr = PyCuSDR(args.configFile, args)
    sdr.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())

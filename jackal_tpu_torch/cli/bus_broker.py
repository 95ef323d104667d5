"""bus-broker CLI: the topic router the node CLIs connect to.

    python -m jackal_tpu_torch.cli.bus_broker [--port 47311]

Plays the role of the ROS master + TCPROS routing for the two-process
composition of the point_cloud and navigate CLIs (launch/stereo.launch).
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m jackal_tpu_torch.cli.bus_broker",
        description="cross-process topic broker (ROS-master equivalent)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=47311)
    ap.add_argument("--run-for", type=float, default=None,
                    help="exit after N seconds (default: run forever)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..io_bus.socket_bus import BusBroker

    broker = BusBroker(args.host, args.port)
    print(f"broker listening on {broker.host}:{broker.port}", flush=True)
    try:
        if args.run_for is not None:
            time.sleep(args.run_for)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

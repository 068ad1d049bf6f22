"""Standalone replication broker: `python -m merklekv_tpu_torch.broker --port 1883`.

A copy of ``merklekv_tpu/broker.py``, its imports pointed at the port's modules.

Self-hosted stand-in for the external MQTT broker the reference depends on
(test.mosquitto.org, the reference's README.md:56). Two wire protocols:

- ``framed`` (default): the length-framed fan-out protocol of
  merklekv_tpu_torch.cluster.transport — minimal and self-describing;
- ``mqtt``: real MQTT 3.1.1 frames (CONNECT/SUBSCRIBE/PUBLISH QoS-0 with
  '#'/'+' filter matching), so an all-MQTT cluster runs self-contained
  and any third-party MQTT 3.1.1 client can join the event fabric.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="merklekv_tpu_torch.broker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=1883)
    p.add_argument(
        "--protocol",
        choices=("framed", "mqtt"),
        default="framed",
        help="wire protocol: length-framed fan-out (default) or MQTT 3.1.1",
    )
    args = p.parse_args(argv)

    if args.protocol == "mqtt":
        from merklekv_tpu_torch.cluster.transport_mqtt import MqttBroker

        broker = MqttBroker(args.host, args.port)
    else:
        from merklekv_tpu_torch.cluster.transport import TcpBroker

        broker = TcpBroker(args.host, args.port)
    print(
        f"merklekv broker ({args.protocol}) listening on "
        f"{broker.host}:{broker.port}",
        flush=True,
    )
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The node validator's CLI on an NVIDIA node: port of
``tpu_operator/validator/cli.py``, with its flags and exit codes.  Runs as
the validator DaemonSet's init containers:

  python -m tpu_operator_torch.validator.cli --component pjrt
  python -m tpu_operator_torch.validator.cli --component jax --with-workload
  python -m tpu_operator_torch.validator.cli --component plugin --wait-only
  python -m tpu_operator_torch.validator.cli --cleanup-all
  python -m tpu_operator_torch.validator.cli --component metrics --metrics-port 8000

Exit 0 on success, 1 when the component fails (and a Warning Event is
posted on the node), 2 on a usage error.  ``--component metrics`` serves
the status files and the card count as Prometheus gauges
(``validator/metrics.py``; ``--oneshot`` prints one scrape and exits).

Importing this module imports no torch: the control-plane components
(libtpu, plugin, ``--wait-only``, ``--cleanup-all``) never pay for it.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from typing import Optional

from tpu_operator_torch import consts
from tpu_operator_torch.obs import events as obs_events
from tpu_operator_torch.obs import logging as obs_logging
from tpu_operator_torch.obs import trace
from tpu_operator_torch.validator import status
from tpu_operator_torch.validator.components import ValidationError, Validator, ValidatorConfig

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("tpu-validator")
    p.add_argument("--component", "-c", default="",
                   help="libtpu|pjrt|plugin|jax|perf|vfio-pci|metrics (or any name with --wait-only)")
    p.add_argument("--node-name", "-n", default=None)
    p.add_argument("--namespace", default=None)
    p.add_argument("--wait-only", action="store_true",
                   help="wait for <component>-ready instead of validating")
    p.add_argument("--with-workload", action="store_true", default=None)
    p.add_argument("--cleanup-all", action="store_true")
    p.add_argument("--sleep-interval-seconds", type=float, default=consts.VALIDATOR_SLEEP_SECONDS)
    p.add_argument("--workload-retries", type=int, default=consts.VALIDATOR_WORKLOAD_RETRIES)
    p.add_argument("--resource-retries", type=int, default=consts.VALIDATOR_RESOURCE_RETRIES)
    p.add_argument("--metrics-port", type=int, default=8000)
    p.add_argument("--oneshot", action="store_true", help="metrics: one scrape pass then exit")
    p.add_argument(
        "--log-format",
        choices=(obs_logging.FORMAT_TEXT, obs_logging.FORMAT_JSON),
        default=os.environ.get(consts.LOG_FORMAT_ENV, obs_logging.FORMAT_TEXT),
    )
    return p.parse_args(argv)


async def run(args: argparse.Namespace) -> int:
    obs_logging.setup(args.log_format)
    log = logging.getLogger("tpu-validator")

    if args.cleanup_all:
        removed = status.cleanup_all()
        log.info("removed %d status files", removed)
        return 0

    if not args.component:
        log.error("--component required")
        return 2

    config = ValidatorConfig(
        sleep_interval=args.sleep_interval_seconds,
        workload_retries=args.workload_retries,
        resource_retries=args.resource_retries,
    )
    if args.node_name is not None:
        config.node_name = args.node_name
    if args.namespace is not None:
        config.namespace = args.namespace
    if args.with_workload is not None:
        config.with_workload = args.with_workload

    if args.component == "metrics":
        from tpu_operator_torch import nvml
        from tpu_operator_torch.validator.metrics import serve_metrics

        try:
            await serve_metrics(args.metrics_port, oneshot=args.oneshot,
                                interval=args.sleep_interval_seconds)
        except nvml.NvmlError as e:
            log.error("metrics: %s", e)
            return 1
        return 0

    validator = Validator(config)
    # the operator stamps TPU_TRACEPARENT into the validator's env: the
    # component spans, and every flight sample under them, join its trace
    tracer = trace.Tracer()
    try:
        with tracer.adopt(trace.TraceContext.from_env()):
            if args.wait_only:
                await validator.wait_ready(args.component)
                log.info("%s-ready present", args.component)
            else:
                await validator.run(args.component)
                log.info("%s validation succeeded", args.component)
        return 0
    except ValidationError as e:
        log.error("%s validation failed: %s", args.component, e)
        # a Warning Event on the node, best-effort: the recorder never
        # raises, and node-local components have no client at all
        if validator._client is not None and config.node_name:
            recorder = obs_events.EventRecorder(
                validator._client, config.namespace, component="tpu-validator"
            )
            await recorder.warning(
                obs_events.node_ref(config.node_name),
                obs_events.REASON_VALIDATION_FAILED,
                f"{args.component} validation failed: {e}",
            )
        return 1
    finally:
        if validator._client is not None:
            await validator._client.close()


def main(argv: Optional[list] = None) -> int:
    return asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())

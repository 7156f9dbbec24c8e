"""The plugin set a node runs, by slice strategy: port of
``tpu_operator/deviceplugin/sliceconfig.py``.

``none`` and ``single`` serve the one ``nvidia.com/gpu`` plugin over every
card (MIG-single semantics: a homogeneous partition still counts under the
flat resource).  ``mixed`` serves one resource per partition shape from
the slice manager's layout file, and goes with the slice manager, which
this package does not have yet: :func:`build_plugin_configs` refuses it.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from tpu_operator_torch.deviceplugin.plugin import GPUDevicePlugin, PluginConfig

log = logging.getLogger("tpu_operator_torch.deviceplugin")

NOT_PORTED = ("the mixed slice strategy reads the slice manager's partition layout, and "
              "this package has no slice manager yet: run --slice-strategy none or single")


class StrategyNotPorted(ValueError):
    pass


def build_plugin_configs(strategy: str, base: Optional[PluginConfig] = None) -> list[PluginConfig]:
    """The plugin set this node runs: the one flat plugin."""
    if strategy == "mixed":
        raise StrategyNotPorted(NOT_PORTED)
    return [base or PluginConfig()]


async def run_plugins(strategy: str, base: PluginConfig) -> None:
    """Serve the plugin set until a plugin fails; the failure ends the
    process (the DaemonSet restarts it), as a node without NVML must."""
    plugins = [GPUDevicePlugin(cfg) for cfg in build_plugin_configs(strategy, base)]
    log.info("serving %d plugin(s): %s", len(plugins),
             [p.config.resource_name for p in plugins])
    try:
        await asyncio.gather(*(plugin.run_forever() for plugin in plugins))
    finally:
        for plugin in plugins:
            await plugin.stop()

"""Partitions of a slice's mesh into boxes of whole cards: own copy of the
part of ``tpu_operator/slices.py`` the slice manager uses
(``PartitionError``, ``Partition``, ``partition_topology``,
``chip_assignments``, ``load_profile``), with the same layouts and the same
error texts.

The reference's partitions are axis-aligned boxes of whole chips cut from
the slice's mesh; it never divides a chip.  On an NVIDIA node the
counterpart is a box of whole cards: a partition unit is this host's share
of one box, served by the device plugin's mixed strategy
(``deviceplugin/sliceconfig.py``).  MIG, which divides one card, is not
used (ROADMAP.md).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

from tpu_operator_torch.utils import parse_topology, topology_chips


class PartitionError(ValueError):
    pass


@dataclass(frozen=True)
class Partition:
    shape: tuple[int, ...]
    origin: tuple[int, ...]

    @property
    def chips(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def coords(self) -> list[tuple[int, ...]]:
        ranges = [range(o, o + s) for o, s in zip(self.origin, self.shape)]
        return [tuple(c) for c in itertools.product(*ranges)]


def _fits(shape: tuple[int, ...], mesh: tuple[int, ...]) -> bool:
    return len(shape) == len(mesh) and all(s <= m and m % s == 0 for s, m in zip(shape, mesh))


def partition_topology(topology: str, shapes: list[str]) -> list[Partition]:
    """Place ``shapes`` (e.g. ["1x2", "1x2"]) into ``topology`` (2x2).

    Greedy first-fit over the mesh in lexicographic order, largest boxes
    first; raises PartitionError unless the shapes tile the mesh exactly (a
    profile fits or is rejected, never applied in part)."""
    mesh = parse_topology(topology)
    want = [parse_topology(s) for s in shapes]
    if not want:
        return []
    total = sum(topology_chips(s) for s in shapes)
    if total != topology_chips(topology):
        raise PartitionError(
            f"shapes {shapes} cover {total} chips; topology {topology} has "
            f"{topology_chips(topology)}"
        )
    for shape in want:
        if not _fits(shape, mesh):
            raise PartitionError(f"shape {'x'.join(map(str, shape))} does not tile {topology}")

    occupied: set[tuple[int, ...]] = set()
    placed: list[Partition] = []
    for shape in sorted(want, key=lambda s: -topology_chips("x".join(map(str, s)))):
        for origin in itertools.product(*[range(m) for m in mesh]):
            if any(o + s > m for o, s, m in zip(origin, shape, mesh)):
                continue
            part = Partition(shape=shape, origin=origin)
            coords = part.coords()
            if any(c in occupied for c in coords):
                continue
            occupied.update(coords)
            placed.append(part)
            break
        else:
            raise PartitionError(f"cannot place {'x'.join(map(str, shape))} in {topology}")
    return placed


def chip_assignments(topology: str, shapes: list[str], chips_per_host: int) -> list[dict]:
    """The layout with flat card ids and owning hosts: ids are row-major
    over the mesh, host h owns [h*chips_per_host, (h+1)*chips_per_host).
    One dict per partition: {shape, origin, chip_ids, hosts}."""
    mesh = parse_topology(topology)
    parts = partition_topology(topology, shapes)

    strides = [1] * len(mesh)
    for i in range(len(mesh) - 2, -1, -1):
        strides[i] = strides[i + 1] * mesh[i + 1]

    out = []
    for part in parts:
        ids = sorted(sum(c * s for c, s in zip(coord, strides)) for coord in part.coords())
        hosts = sorted({i // chips_per_host for i in ids}) if chips_per_host else []
        out.append({"shape": "x".join(map(str, part.shape)), "origin": list(part.origin),
                    "chip_ids": ids, "hosts": hosts})
    return out


def load_profile(config: dict, profile: str, accelerator: str, topology: str) -> list[str]:
    """A named profile of the slice-config ConfigMap
    (``assets/state-slice-manager/0400_configmap.yaml``) resolved to the
    partition shapes for this node's accelerator and topology; an empty
    list is the whole slice."""
    profiles = config.get("slice-configs") or {}
    if profile not in profiles:
        raise PartitionError(f"unknown slice profile {profile!r}")
    for rule in profiles[profile]:
        accels = rule.get("accelerators") or ["*"]
        if "*" not in accels and accelerator not in accels:
            continue
        rule_topo = rule.get("topology")
        if rule_topo and rule_topo != topology:
            continue
        return list(rule.get("partitions") or [])
    raise PartitionError(
        f"profile {profile!r} has no rule for accelerator={accelerator} topology={topology}"
    )

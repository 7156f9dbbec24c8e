"""Accelerator catalogue for NVIDIA cards: the port's counterpart of the
TPU table in ``tpu_operator/k8s/nodeinfo.py``.

The peaks are NVIDIA's data-sheet numbers, dense (no sparsity), at the
card's full power limit; a card set below it runs slower under load.  They
are the denominators of the port's roofline and bandwidth shares, never
measurements.

The interconnect figures arm the validator's bandwidth gates
(``validator/components.py``), in the place of the reference's ICI and DCN
figures:

- ``nvlink_gbps``: the card's aggregate NVLink rate, both directions
  together, as the data sheet states it (900 GB/s for the SXM parts: 18
  NVLink-4 links of 50 GB/s; 600 GB/s over the PCIe and NVL parts' bridges:
  12 links).  ``nvlink_link_gbps`` = aggregate / links, 50 GB/s, is the
  per-link rate the ring diagnostic's floor derives from, as the
  reference's per-link floor derives from aggregate / torus degree.
- The allreduce floor in the port's convention.  ``busbw_gbps`` counts the
  global buffer, as the reference does: for n cards each holding S bytes
  reduced in time t it is 2(n-1)·S/t, which is n times the NCCL-tests busbw
  2(n-1)/n·S/t.  NCCL's busbw cannot exceed one direction of a card's
  NVLink, nvlink_gbps / 2, so a healthy node's ``busbw_gbps`` is at most
  n·nvlink_gbps/2 (4 H100 SXM: 1800 GB/s).  The gate takes the reference's
  fraction of that ceiling, ``ALLREDUCE_GATE_FRACTION``·n·nvlink_gbps/2
  (4 H100 SXM: 450 GB/s), so the floor grows with the cards as the measured
  number does; a floor fixed for every n would pass a large node at any
  speed or fail a small healthy one.
- ``nic_gbps``: the host's NIC line rate for traffic between hosts, of the
  smallest common host shape of the part (H100 SXM: four 200 Gb/s GPU NICs,
  100 GB/s; H200: eight 400 Gb/s, 400 GB/s; the PCIe and NVL parts: one
  200 Gb/s, 25 GB/s), one direction, as line rates are stated: the ceiling
  the floors between hosts derive from.
- The slice floor.  An H100 SXM NVLink domain is one host of 8 cards, so
  the hosts of a multi-host slice talk through their NICs, and a slice's
  allreduce is held to the NIC rate, not NVLink.  NCCL's ring runs c
  channels, each leaving every host by one edge that carries 2(n-1)/n·S/c
  bytes; all c leave through the host's NICs, so t >= 2(n-1)/n·S/nic_gbps
  and NCCL-tests' busbw across hosts is at most nic_gbps.  In the port's
  convention the ceiling is n·nic_gbps, n the slice's cards in all (hosts
  x cards per host), and the floor is the reference's slice fraction of
  it, ``ALLREDUCE_GATE_FRACTION``·n·nic_gbps (two H100 SXM hosts of 8
  cards: 0.25 x 16 x 100 = 400 GB/s).  The cross-slice floor
  (``_multislice_min_gbps``, ``DCN_GATE_FRACTION``·nic_gbps, the
  reference's rule) has no n: it is 0.1/n of the same ceiling, so the
  slice does not reuse it, and only the cross-slice run keeps it.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_operator_torch import consts
from tpu_operator_torch.utils import parse_topology, topology_chips


@dataclass(frozen=True)
class AcceleratorInfo:
    generation: str          # h100-sxm | h100-pcie | h100-nvl | h200
    hbm_gb: int              # device memory per card (GB)
    peak_bf16_tflops: float  # dense bf16 tensor-core peak
    hbm_gbps: float          # device memory bandwidth, GB/s
    peak_fp32_tflops: float = 0.0  # f32 on the CUDA cores, outside the tensor cores
    peak_tf32_tflops: float = 0.0  # dense TF32 on the tensor cores: half the bf16 peak
    nvlink_gbps: float = 0.0       # aggregate NVLink rate, both directions, GB/s
    nvlink_links: int = 18         # NVLink links per card
    nic_gbps: float = 0.0          # per-HOST NIC line rate between hosts, GB/s

    @property
    def nvlink_link_gbps(self) -> float:
        """Per-link NVLink rate: the ring diagnostic's denominator."""
        return self.nvlink_gbps / max(1, self.nvlink_links)


ACCELERATORS: dict[str, AcceleratorInfo] = {
    "h100-sxm": AcceleratorInfo("h100-sxm", 80, 989.0, 3350.0, 67.0, 494.5, 900.0, 18, 100.0),
    "h100-pcie": AcceleratorInfo("h100-pcie", 80, 756.0, 2000.0, 51.0, 378.0, 600.0, 12, 25.0),
    "h100-nvl": AcceleratorInfo("h100-nvl", 94, 835.0, 3900.0, 60.0, 417.5, 600.0, 12, 25.0),
    "h200": AcceleratorInfo("h200", 141, 989.0, 4800.0, 67.0, 494.5, 900.0, 18, 400.0),
}

UNKNOWN_ACCELERATOR = AcceleratorInfo("unknown", 0, 0.0, 0.0)

# substrings of torch.cuda.get_device_name, most specific first (the SXM
# part reports itself as "NVIDIA H100 80GB HBM3")
_NAME_PATTERNS = (
    ("H100 NVL", "h100-nvl"),
    ("H100 PCIe", "h100-pcie"),
    ("H200", "h200"),
    ("H100", "h100-sxm"),
)


def generation_info(generation: str) -> AcceleratorInfo:
    """Peaks by generation; zeros for one not in the table."""
    return ACCELERATORS.get(generation, UNKNOWN_ACCELERATOR)


def generation_of(name: str) -> str:
    """Generation from a card name as CUDA reports it; "unknown" when no
    pattern matches."""
    for pattern, generation in _NAME_PATTERNS:
        if pattern in name:
            return generation
    return "unknown"


def detect_generation(device=None) -> str:
    """Generation of ``device`` (default: the current card); "cpu" for the
    CPU.  Imports torch here, not at the top: the validator's control-plane
    components read this module without paying for torch."""
    import torch

    device = torch.device(device) if device is not None else torch.device("cuda")
    if device.type == "cpu":
        return "cpu"
    return generation_of(torch.cuda.get_device_name(device))


def _labels(node: dict) -> dict:
    return (node.get("metadata") or {}).get("labels") or {}


def generation_of_node(node: dict) -> str:
    """Generation of a Node's cards from its ``nvidia.com/gpu.product``
    label (e.g. ``NVIDIA-H100-80GB-HBM3``).  The label writes "-" where
    CUDA's card name has a space, so it is read with spaces: else
    ``NVIDIA-H100-NVL`` would match only the plain "H100" pattern."""
    return generation_of(_labels(node).get(consts.GPU_PRODUCT_LABEL, "").replace("-", " "))


# The reference's multi-host slice identity (``controllers.labels.
# slice_group_key`` over ``k8s/nodeinfo.py``): a node whose GKE TPU labels
# say its slice spans more than one host.  Chips per host by accelerator
# label, 4 for a label the reference does not know.
_TPU_CHIPS_PER_HOST = {"tpu-v5-lite-device": 8, "tpu-v6e-device": 8}


def _chips_per_host(labels: dict) -> int:
    """The reference's ``chips_per_host``: the accelerator's default, cut
    to the topology's chips for a single-host (at most 2-D) shape."""
    base = _TPU_CHIPS_PER_HOST.get(labels.get(consts.GKE_TPU_ACCELERATOR_LABEL, ""), 4)
    topology = labels.get(consts.GKE_TPU_TOPOLOGY_LABEL)
    if topology:
        try:
            if len(parse_topology(topology)) <= 2:
                return min(base, topology_chips(topology))
        except ValueError:
            pass
    return base


def slice_hosts(node: dict) -> int:
    """Hosts forming this node's slice (topology chips / chips per host)."""
    labels = _labels(node)
    topology = labels.get(consts.GKE_TPU_TOPOLOGY_LABEL, "")
    if not topology:
        return 1
    try:
        return max(1, topology_chips(topology) // max(1, _chips_per_host(labels)))
    except ValueError:
        return 1


def slice_group_key(node: dict) -> str:
    """The node's multi-host slice (its nodepool) when the reference's
    validator would validate it as a slice member; "" otherwise, and ""
    without a nodepool label (two slices must never merge into one)."""
    labels = _labels(node)
    if not labels.get(consts.GKE_TPU_ACCELERATOR_LABEL) or not labels.get(
            consts.GKE_TPU_TOPOLOGY_LABEL):
        return ""
    if slice_hosts(node) <= 1:
        return ""
    return labels.get(consts.GKE_NODEPOOL_LABEL, "")


def node_name(node: dict) -> str:
    return (node.get("metadata") or {}).get("name", "")


def worker_id(node: dict) -> str:
    """The host's slice worker id label, feature discovery's before GKE's;
    "" when neither is set."""
    labels = _labels(node)
    return str(labels.get(consts.TFD_SLICE_WORKER_ID_LABEL)
               or labels.get(consts.GKE_TPU_WORKER_ID_LABEL, ""))


def runtime_version(node: dict) -> str:
    """The runtime version label feature discovery reports ("" if none)."""
    return _labels(node).get(consts.TFD_RUNTIME_VERSION_LABEL, "")


class NodeFilter:
    """The part of the reference's node predicate the slice branch uses:
    label equalities and the accelerator label's presence, applied to a
    node list."""

    def __init__(self) -> None:
        self._eq: dict[str, str] = {}
        self._exists: list[str] = []

    def eq(self, key: str, value: str) -> "NodeFilter":
        self._eq[key] = value
        return self

    def tpu(self) -> "NodeFilter":
        """Nodes carrying the GKE accelerator label: the slice identity's."""
        self._exists.append(consts.GKE_TPU_ACCELERATOR_LABEL)
        return self

    def apply(self, nodes) -> list[dict]:
        def matches(labels: dict) -> bool:
            return (all(labels.get(k) == v for k, v in self._eq.items())
                    and all(k in labels for k in self._exists))

        return [n for n in nodes if matches(_labels(n))]

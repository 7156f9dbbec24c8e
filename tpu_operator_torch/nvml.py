"""The node's card inventory through NVML, the driver's management library:
the port's counterpart of ``tpu_operator/hw.py``'s chip discovery
(``accel_device_paths``, ``chip_count``) and of what libtpu's runtime
endpoint reports per chip.

NVML is bound with ``ctypes`` (``libnvidia-ml.so.1``, or the versioned file
the driver installs, found as ``hw.libcuda_path`` finds ``libcuda``) and
initialised once per process.  Three calls serve the node agents:

- :func:`inventory`: every card NVML lists (index, UUID, minor number,
  name, memory) and the driver's and CUDA's versions;
- :func:`sample`: one card's counters now (utilization, memory in use,
  NVLink data bytes);
- :func:`topology`: the PCIe common ancestor of each pair of cards, where
  the driver reports it;
- :func:`pci_addresses`: each card's PCI address as sysfs names it.

A card's identity is its UUID.  NVML's index, CUDA's index and the number
of its ``/dev`` node need not agree: CUDA orders the cards fastest first,
NVML by PCI bus, and the node is ``/dev/nvidia<minor>``.

A node without NVML fails loudly: the first call raises :class:`NvmlError`
naming the library.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass
from typing import Optional

from tpu_operator_torch import hw

LIBRARY = "libnvidia-ml.so.1"

SUCCESS = 0
ERROR_NOT_SUPPORTED = 3
ERROR_GPU_IS_LOST = 15

# nvmlDeviceGetFieldValues ids: NVLink data bytes, in KiB, per link (the
# scope id); protocol overhead excluded
FI_NVLINK_DATA_TX = 138
FI_NVLINK_DATA_RX = 139
NVLINK_MAX_LINKS = 18

# nvmlDeviceGetTopologyCommonAncestor's levels, nearest first
TOPOLOGY_LEVELS = {0: "internal", 10: "single-switch", 20: "multiple-switches",
                   30: "host-bridge", 40: "numa-node", 50: "system"}
TOPOLOGY_SYSTEM = 50

_STRING = 96  # NVML's longest UUID and name buffers


class NvmlError(RuntimeError):
    """An NVML call that did not succeed; ``code`` is its nvmlReturn_t."""

    def __init__(self, message: str, code: int = -1):
        super().__init__(message)
        self.code = code


@dataclass(frozen=True)
class Card:
    index: int          # NVML's index: neither CUDA's order nor the /dev number
    uuid: str           # "GPU-…": the device plugin's device id
    minor: int          # the card's node is /dev/nvidia<minor>
    name: str           # e.g. "NVIDIA H100 80GB HBM3"
    memory_total: int   # bytes
    lost: bool = False  # NVML answered "GPU is lost" for it


@dataclass(frozen=True)
class Inventory:
    cards: tuple
    driver_version: str  # e.g. "570.124.06"
    cuda_version: str    # the driver's CUDA version, e.g. "12.8"
    device_count: int = 0  # NVML's count, the cards lost before their UUID included


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class _Value(ctypes.Union):
    _fields_ = [("dVal", ctypes.c_double), ("uiVal", ctypes.c_uint),
                ("ulVal", ctypes.c_ulong), ("ullVal", ctypes.c_ulonglong),
                ("sllVal", ctypes.c_longlong)]


class _PciInfo(ctypes.Structure):
    _fields_ = [("busIdLegacy", ctypes.c_char * 16), ("domain", ctypes.c_uint),
                ("bus", ctypes.c_uint), ("device", ctypes.c_uint),
                ("pciDeviceId", ctypes.c_uint), ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class _FieldValue(ctypes.Structure):
    _fields_ = [("fieldId", ctypes.c_uint), ("scopeId", ctypes.c_uint),
                ("timestamp", ctypes.c_longlong), ("latencyUsec", ctypes.c_longlong),
                ("valueType", ctypes.c_int), ("nvmlReturn", ctypes.c_int),
                ("value", _Value)]


_HANDLE = ctypes.c_void_p
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlSystemGetDriverVersion": [ctypes.c_char_p, ctypes.c_uint],
    "nvmlSystemGetCudaDriverVersion_v2": [ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMinorNumber": [_HANDLE, ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, ctypes.POINTER(_Memory)],
    "nvmlDeviceGetUtilizationRates": [_HANDLE, ctypes.POINTER(_Utilization)],
    "nvmlDeviceGetFieldValues": [_HANDLE, ctypes.c_int, ctypes.POINTER(_FieldValue)],
    "nvmlDeviceGetTopologyCommonAncestor": [_HANDLE, _HANDLE, ctypes.POINTER(ctypes.c_int)],
    "nvmlDeviceGetPciInfo_v3": [_HANDLE, ctypes.POINTER(_PciInfo)],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """NVML, loaded and initialised once per process (NVML counts its
    initialisations; the process's exit releases it)."""
    path = hw.libnvml_path() or LIBRARY
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NvmlError(f"NVML ({LIBRARY}) not found under {hw.hw_root()!r} nor by the "
                        f"loader: {e}") from None
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _call(lib, "nvmlInit_v2")
    return lib


def _call(lib: ctypes.CDLL, name: str, *args) -> None:
    code = getattr(lib, name)(*args)
    if code != SUCCESS:
        text = (lib.nvmlErrorString(code) or b"").decode(errors="replace")
        raise NvmlError(f"{LIBRARY}: {name} returned {code} ({text})", code)


def _text(lib: ctypes.CDLL, name: str, *args) -> str:
    buf = ctypes.create_string_buffer(_STRING)
    _call(lib, name, *args, buf, _STRING)
    return buf.value.decode()


def _handle(lib: ctypes.CDLL, uuid: str) -> ctypes.c_void_p:
    handle = _HANDLE()
    _call(lib, "nvmlDeviceGetHandleByUUID", uuid.encode(), ctypes.byref(handle))
    return handle


def cuda_version_text(version: int) -> str:
    """NVML's integer CUDA version (1000 x major + 10 x minor) as text."""
    return f"{version // 1000}.{version % 1000 // 10}"


def inventory() -> Inventory:
    """Every card NVML lists, in NVML's order.  A card that answers "GPU is
    lost" before it gives its UUID is left out (a caller that saw it before
    keeps it as lost); one that answers so after is listed ``lost``."""
    lib = _library()
    count = ctypes.c_uint()
    _call(lib, "nvmlDeviceGetCount_v2", ctypes.byref(count))
    cards = []
    for index in range(count.value):
        handle = _HANDLE()
        try:
            _call(lib, "nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(handle))
            uuid = _text(lib, "nvmlDeviceGetUUID", handle)
        except NvmlError as e:
            if e.code == ERROR_GPU_IS_LOST:
                continue
            raise
        try:
            minor, memory = ctypes.c_uint(), _Memory()
            _call(lib, "nvmlDeviceGetMinorNumber", handle, ctypes.byref(minor))
            _call(lib, "nvmlDeviceGetMemoryInfo", handle, ctypes.byref(memory))
            name = _text(lib, "nvmlDeviceGetName", handle)
        except NvmlError as e:
            if e.code != ERROR_GPU_IS_LOST:
                raise
            cards.append(Card(index, uuid, -1, "", 0, lost=True))
            continue
        cards.append(Card(index, uuid, minor.value, name, memory.total))
    cuda = ctypes.c_int()
    _call(lib, "nvmlSystemGetCudaDriverVersion_v2", ctypes.byref(cuda))
    return Inventory(tuple(cards), _text(lib, "nvmlSystemGetDriverVersion"),
                     cuda_version_text(cuda.value), count.value)


def _supported(fn) -> bool:
    """Run one query; False when the card does not support it (not an
    error), True when it answered; any other failure raises."""
    try:
        fn()
    except NvmlError as e:
        if e.code == ERROR_NOT_SUPPORTED:
            return False
        raise
    return True


def _field_number(value: _FieldValue) -> float:
    kind = value.valueType
    return float(value.value.dVal if kind == 0 else value.value.uiVal if kind == 1
                 else value.value.ulVal if kind == 2 else value.value.sllVal if kind == 4
                 else value.value.ullVal)


def _nvlink_bytes(lib: ctypes.CDLL, handle) -> Optional[tuple]:
    """(TX, RX) NVLink data bytes summed over the links that answer; None
    when no link does (no NVLink, or the counters are not supported)."""
    fields = [(fid, link) for fid in (FI_NVLINK_DATA_TX, FI_NVLINK_DATA_RX)
              for link in range(NVLINK_MAX_LINKS)]
    values = (_FieldValue * len(fields))()
    for value, (fid, link) in zip(values, fields):
        value.fieldId, value.scopeId = fid, link
    if not _supported(lambda: _call(lib, "nvmlDeviceGetFieldValues", handle,
                                    len(fields), values)):
        return None
    sums = {FI_NVLINK_DATA_TX: 0.0, FI_NVLINK_DATA_RX: 0.0}
    answered = False
    for value in values:
        if value.nvmlReturn == SUCCESS:
            sums[value.fieldId] += _field_number(value) * 1024.0
            answered = True
    return (sums[FI_NVLINK_DATA_TX], sums[FI_NVLINK_DATA_RX]) if answered else None


def sample(card: Card) -> dict:
    """One card's counters now, by the card's UUID:
    ``gpu_utilization_percent`` (the share of the last sample period, up to
    a second by product, in which a kernel ran), ``memory_total_bytes``,
    ``memory_used_bytes`` (the CUDA contexts and the allocators' reserves
    included) and ``nvlink_tx_bytes``/``nvlink_rx_bytes`` (data since the
    driver loaded).  A counter the card does not support is left out; any
    other failed query raises :class:`NvmlError`."""
    lib = _library()
    handle = _handle(lib, card.uuid)
    out = {}
    util, memory = _Utilization(), _Memory()
    if _supported(lambda: _call(lib, "nvmlDeviceGetUtilizationRates", handle,
                                ctypes.byref(util))):
        out["gpu_utilization_percent"] = float(util.gpu)
    if _supported(lambda: _call(lib, "nvmlDeviceGetMemoryInfo", handle, ctypes.byref(memory))):
        out["memory_total_bytes"] = float(memory.total)
        out["memory_used_bytes"] = float(memory.used)
    nvlink = _nvlink_bytes(lib, handle)
    if nvlink is not None:
        out["nvlink_tx_bytes"], out["nvlink_rx_bytes"] = nvlink
    return out


def topology(uuids: list) -> dict:
    """{frozenset((a, b)): level} for the pairs of the cards ``uuids``
    whose PCIe common ancestor NVML reports (``TOPOLOGY_LEVELS``; lower is
    nearer).  A pair NVML does not support the query for is left out (a
    sandboxed driver answers so for every pair)."""
    lib = _library()
    handles = {uuid: _handle(lib, uuid) for uuid in uuids}
    out = {}
    for a, b in itertools.combinations(uuids, 2):
        level = ctypes.c_int()
        if _supported(lambda: _call(lib, "nvmlDeviceGetTopologyCommonAncestor", handles[a],
                                    handles[b], ctypes.byref(level))):
            out[frozenset((a, b))] = level.value
    return out


def pci_address(bus_id: str) -> str:
    """NVML's bus id ("00000000:18:00.0", eight hex digits of domain) as
    sysfs names the function ("0000:18:00.0")."""
    domain, bus, devfn = bus_id.strip().lower().split(":")
    return f"{int(domain, 16):04x}:{bus}:{devfn}"


def pci_addresses(uuids: list) -> dict:
    """{uuid: PCI address} of the cards ``uuids`` whose PCI information
    NVML reports (a sandboxed driver answers "not supported")."""
    lib = _library()
    out = {}
    for uuid in uuids:
        info = _PciInfo()
        if _supported(lambda: _call(lib, "nvmlDeviceGetPciInfo_v3", _handle(lib, uuid),
                                    ctypes.byref(info))):
            out[uuid] = pci_address(info.busId.decode())
    return out

"""The port's NVML binding (``tpu_operator_torch/nvml.py``) against a fake
library that answers through the same C calling shapes: the inventory, a
card lost before and after it gives its UUID, counters a card does not
support, the NVLink field sums, the topology, and the loud failure on a
node without NVML.  The real library answers on the card (chip_smoke.py's
agents phase)."""

import ctypes
import os

import pytest

from tpu_operator_torch import hw, nvml

OK, NOT_SUPPORTED, LOST = nvml.SUCCESS, nvml.ERROR_NOT_SUPPORTED, nvml.ERROR_GPU_IS_LOST
GiB = 1 << 30


class FakeNvml:
    """Three devices: 0 answers everything, 1 is lost after its UUID, 2 is
    lost before it.  ``util_code``/``links`` shape device 0's counters."""

    def __init__(self, util_code=OK, links=4, field_code=OK, topology_code=OK):
        self.calls = []

        def fn(name, body):
            def call(*args):
                self.calls.append(name)
                return body(*args)
            setattr(self, name, call)

        def handle_value(h):
            return h.value if isinstance(h, ctypes.c_void_p) else h

        def by_index(i, out):
            if i == 2:
                return LOST
            out._obj.value = 100 + i
            return OK

        def by_uuid(uuid, out):
            out._obj.value = 100 + int(uuid.decode()[-1])
            return OK

        def text(value):
            def body(*args):
                buf = args[-2]
                buf.value = value(*args[:-2]).encode()
                return OK
            return body

        def minor(h, out):
            if handle_value(h) == 101:
                return LOST
            out._obj.value = 4
            return OK

        def memory(h, out):
            out._obj.total, out._obj.used, out._obj.free = 80 * GiB, 3 * GiB, 77 * GiB
            return OK

        def utilization(h, out):
            out._obj.gpu = 87
            return util_code

        def fields(h, count, values):
            if field_code != OK:
                return field_code
            for v in values[:count]:
                good = v.scopeId < links
                v.nvmlReturn = OK if good else NOT_SUPPORTED
                v.valueType = 3
                v.value.ullVal = (10 if v.fieldId == nvml.FI_NVLINK_DATA_TX else 20) if good else 0
            return OK

        def pci_info(h, out):
            if handle_value(h) == 103:
                return NOT_SUPPORTED
            out._obj.busId = f"00000000:{handle_value(h) - 100 + 0x18:02X}:00.0".encode()
            return OK

        def ancestor(a, b, out):
            out._obj.value = 10 if {handle_value(a), handle_value(b)} == {100, 101} else 40
            return topology_code

        fn("nvmlInit_v2", lambda: OK)
        fn("nvmlErrorString", lambda code: f"error {code}".encode())
        fn("nvmlDeviceGetCount_v2", lambda out: setattr(out._obj, "value", 3) or OK)
        fn("nvmlDeviceGetHandleByIndex_v2", by_index)
        fn("nvmlDeviceGetHandleByUUID", by_uuid)
        fn("nvmlDeviceGetUUID", text(lambda h: f"GPU-0000-{handle_value(h) - 100}"))
        fn("nvmlDeviceGetName", text(lambda h: "NVIDIA H100 80GB HBM3"))
        fn("nvmlSystemGetDriverVersion", text(lambda: "570.124.06"))
        fn("nvmlSystemGetCudaDriverVersion_v2", lambda out: setattr(out._obj, "value", 12080) or OK)
        fn("nvmlDeviceGetMinorNumber", minor)
        fn("nvmlDeviceGetMemoryInfo", memory)
        fn("nvmlDeviceGetUtilizationRates", utilization)
        fn("nvmlDeviceGetFieldValues", fields)
        fn("nvmlDeviceGetTopologyCommonAncestor", ancestor)
        fn("nvmlDeviceGetPciInfo_v3", pci_info)


@pytest.fixture
def fake(monkeypatch):
    """Install a FakeNvml as the loaded library; the test sets its shape."""
    made = {}

    def install(**kw):
        lib = FakeNvml(**kw)
        made["lib"] = lib
        monkeypatch.setattr(nvml.ctypes, "CDLL", lambda path: lib)
        nvml._library.cache_clear()
        return lib

    yield install
    nvml._library.cache_clear()


def test_field_value_layout_is_nvmls():
    # nvmlFieldValue_t: two uints, two long longs, two ints, an 8-byte union
    assert ctypes.sizeof(nvml._FieldValue) == 40
    assert ctypes.sizeof(nvml._Memory) == 24
    assert nvml.cuda_version_text(12080) == "12.8" and nvml.cuda_version_text(11040) == "11.4"


def test_inventory_keeps_lost_cards_apart(fake):
    lib = fake()
    inv = nvml.inventory()
    assert inv.driver_version == "570.124.06" and inv.cuda_version == "12.8"
    assert inv.device_count == 3
    assert inv.cards == (
        nvml.Card(0, "GPU-0000-0", 4, "NVIDIA H100 80GB HBM3", 80 * GiB),
        nvml.Card(1, "GPU-0000-1", -1, "", 0, lost=True),  # lost after its UUID
    )  # device 2, lost before its UUID, is left out
    nvml.inventory()
    assert lib.calls.count("nvmlInit_v2") == 1  # once per process


@pytest.mark.parametrize("links, expect", [(4, (4 * 10 * 1024.0, 4 * 20 * 1024.0)),
                                           (18, (18 * 10 * 1024.0, 18 * 20 * 1024.0)),
                                           (0, None)])
def test_sample_sums_the_nvlink_links_that_answer(fake, links, expect):
    fake(links=links)
    got = nvml.sample(nvml.inventory().cards[0])
    assert got["gpu_utilization_percent"] == 87.0
    assert (got["memory_total_bytes"], got["memory_used_bytes"]) == (80 * GiB, 3 * GiB)
    nvlink = (got["nvlink_tx_bytes"], got["nvlink_rx_bytes"]) if "nvlink_tx_bytes" in got else None
    assert nvlink == expect


def test_unsupported_counters_are_left_out_not_errors(fake):
    fake(util_code=NOT_SUPPORTED, field_code=NOT_SUPPORTED)
    got = nvml.sample(nvml.inventory().cards[0])
    assert set(got) == {"memory_total_bytes", "memory_used_bytes"}


def test_a_failed_query_raises(fake):
    fake(util_code=LOST)
    with pytest.raises(nvml.NvmlError, match="nvmlDeviceGetUtilizationRates") as ei:
        nvml.sample(nvml.inventory().cards[0])
    assert ei.value.code == LOST


def test_topology_pairs(fake):
    fake()
    levels = nvml.topology(["GPU-0000-0", "GPU-0000-1", "GPU-0000-3"])
    assert levels == {frozenset(("GPU-0000-0", "GPU-0000-1")): 10,
                      frozenset(("GPU-0000-0", "GPU-0000-3")): 40,
                      frozenset(("GPU-0000-1", "GPU-0000-3")): 40}


def test_topology_not_supported_leaves_the_pairs_out(fake):
    fake(topology_code=NOT_SUPPORTED)  # the card machine's sandboxed driver
    assert nvml.topology(["GPU-0000-0", "GPU-0000-1"]) == {}
    fake(topology_code=LOST)
    with pytest.raises(nvml.NvmlError):
        nvml.topology(["GPU-0000-0", "GPU-0000-1"])


def test_pci_addresses_as_sysfs_names_them(fake):
    fake()
    assert ctypes.sizeof(nvml._PciInfo) == 68  # nvmlPciInfo_t
    assert nvml.pci_addresses(["GPU-0000-0", "GPU-0000-1"]) == {
        "GPU-0000-0": "0000:18:00.0", "GPU-0000-1": "0000:19:00.0"}
    # a card the driver gives no PCI information for is left out (the
    # card machine's sandboxed driver answers so)
    assert nvml.pci_addresses(["GPU-0000-0", "GPU-0000-3"]) == {"GPU-0000-0": "0000:18:00.0"}
    assert nvml.pci_address("00000001:AB:1F.3") == "0001:ab:1f.3"


def test_no_nvml_fails_loudly_naming_the_library(monkeypatch):
    def missing(path):
        raise OSError(f"{path}: cannot open shared object file")

    monkeypatch.setattr(nvml.ctypes, "CDLL", missing)
    nvml._library.cache_clear()
    try:
        with pytest.raises(nvml.NvmlError, match=r"libnvidia-ml\.so\.1"):
            nvml.inventory()
    finally:
        nvml._library.cache_clear()


def test_library_found_as_libcuda_is(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_HW_ROOT", str(tmp_path))
    monkeypatch.delenv("LIBCUDA_PATH", raising=False)
    assert hw.libnvml_path() == ""
    lib = tmp_path / "usr" / "lib" / "x86_64-linux-gnu"
    lib.mkdir(parents=True)
    # only the versioned files, as the card machine carries libcuda
    for name in ("libnvidia-ml.so.550.54.15", "libcuda.so.550.54.15", "libnvidia-ml.so.x"):
        (lib / name).touch()
    assert hw.libnvml_path() == str(lib / "libnvidia-ml.so.550.54.15")
    assert hw.libcuda_path() == str(lib / "libcuda.so.550.54.15")
    (lib / "libnvidia-ml.so.1").touch()
    assert hw.libnvml_path() == os.path.join(str(lib), "libnvidia-ml.so.1")

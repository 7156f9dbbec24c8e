"""The most device memory in use on a card while child processes run on
it, read from NVML (``libnvidia-ml.so.1``) in a thread every 0.1 s: the
readiness gate's passes are processes of their own, whose allocator the
benchmark cannot ask."""

from __future__ import annotations

import ctypes
import threading


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class MemoryPeak:
    """``with MemoryPeak(index) as m: ...`` then ``m.peak``: the largest
    ``used`` NVML read for card ``index`` (0 when NVML cannot be read)."""

    def __init__(self, index: int = 0, interval: float = 0.1):
        self.index, self.interval = index, interval
        self.peak = 0
        self._stop = threading.Event()
        self._thread = None

    def _reader(self):
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return None
        handle = ctypes.c_void_p()
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [ctypes.c_uint,
                                                      ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetMemoryInfo.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Memory)]
        if lib.nvmlInit_v2() != 0 or lib.nvmlDeviceGetHandleByIndex_v2(self.index,
                                                                        ctypes.byref(handle)):
            return None
        memory = _Memory()

        def read() -> int:
            ok = lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(memory)) == 0
            return memory.used if ok else 0

        return read

    def _poll(self, read) -> None:
        while True:
            self.peak = max(self.peak, read())
            if self._stop.wait(self.interval):
                return

    def __enter__(self):
        read = self._reader()
        if read is not None:
            self._thread = threading.Thread(target=self._poll, args=(read,), daemon=True)
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return False

"""Peaks of the card and the bytes each kernel must move, frozen here.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit; a run
prints the card's own ``power.limit`` beside them.  A kernel's bytes count
each input byte read once and each output byte written once, from the
shape arguments of the program's ``kernel:<name>`` spans.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, HBM3
PEAK_NOTE = "H100 SXM data sheet: 3.35 TB/s HBM3 at 700 W"


def expand_many_bytes(k: int, runs: int, total: int) -> int:
    """K int32 payloads of ``runs`` and the int32 bounds read, K int32
    columns of ``total`` written."""
    return (k * total + k * runs + runs) * 4


def mul_segsum_bytes(n: int, segments: int, dtype: str = "int64") -> int:
    """int32 segment ids and two 8-byte operands of ``n`` read (int64 or
    float64: the wrapper casts to the accumulation type), ``segments``
    8-byte sums written."""
    return n * 4 + 2 * n * 8 + segments * 8


# span name -> (device kernel name, bytes from the span's arguments)
KERNELS = {
    "expand_many": (("kernel:rle_expand_many", lambda a: expand_many_bytes(
                        a["k"], a["runs"], a["total"])),
                    ("kernel:rle_expand", lambda a: expand_many_bytes(
                        1, a["runs"], a["total"]))),
    "mul_segsum": (("kernel:mul_segsum", lambda a: mul_segsum_bytes(
                       a["n"], a["segments"], a.get("dtype", "int64"))),),
}
DEVICE_NAMES = {"expand_many": "expand_many_kernel",
                "mul_segsum": "segsum_pass"}


def share(kernel: str, window) -> float | None:
    """Percent of the HBM bound that ``kernel`` reached over the traced
    window: its bytes at the peak over its device time.  None where the
    window launched it not at all."""
    if window.device is None:
        return None
    nbytes = 0
    for span_name, count in KERNELS[kernel]:
        for sp in window.spans_named(span_name):
            nbytes += count(sp.args)
    seconds = window.device.kernel_seconds(DEVICE_NAMES[kernel])
    if nbytes == 0 or seconds <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds

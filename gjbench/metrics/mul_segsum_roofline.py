"""``mul_segsum``'s share of its HBM bound over the traced window, in %:
bytes from the ``kernel:mul_segsum`` spans' shapes (``gjbench/roofline.py``)
at the peak, over the device time of its passes."""

from gjbench.roofline import share


def read(window):
    return share("mul_segsum", window)

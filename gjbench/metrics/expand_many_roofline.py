"""``expand_many``'s share of its HBM bound over the traced window, in %:
bytes from the ``kernel:rle_expand_many`` spans' shapes
(``gjbench/roofline.py``) at the peak, over the kernel's device time."""

from gjbench.roofline import share


def read(window):
    return share("expand_many", window)

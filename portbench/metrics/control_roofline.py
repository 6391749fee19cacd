"""The fused control launch's share of its roofline over the traced study
(``portbench/roofline/control.py``), percent."""

from portbench.roofline import kernel_share


def read(run):
    return kernel_share(run, "control")

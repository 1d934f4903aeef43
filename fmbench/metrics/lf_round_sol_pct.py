"""The LF rounds' least bytes at the HBM rate, as a share of the device time of
the kernels that run them (names holding one of ``KERNELS``)."""

from fmbench.derive import lf_round_sol_pct

#: substrings of the names of the kernels that run LF rounds
KERNELS = ("lf_round",)


def read(run):
    return lf_round_sol_pct(run, KERNELS)

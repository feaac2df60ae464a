"""The least time of the two alignment DPs' kernels, from the work their
shapes give: the yardstick of ``gotoh_dp_roofline`` and
``refine_dp_roofline``, copied from chip_smoke.py (its CUDA-core rates and
its counts of a DP cell's operations) so that a later change to the port
cannot move it.  Only shapes are read, so the same work is counted
whatever implements it.

Rates of one NVIDIA H100 SXM: 132 SMs, each with 64 int32 and 128 fp32
lanes doing one add, max or compare a clock, at the 1.98 GHz boost clock.
"""

INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
# a Gotoh cell in int32: the substitution 2, F and its flag 4, diag, vert,
# the pointer's move, t, the running max, E, its flag and V 1 each, E >
# vert and its select 2, the pointer byte 4
GOTOH_OPS_PER_CELL = 20
# a refine cell in fp32: the open add, compare, max and add, the
# diagonal's add, the skip compare and select; a column and member: the
# six profile terms and the end column's compare and select
REFINE_OPS_PER_CELL = 7
REFINE_OPS_PER_COLUMN = 8


def gotoh_bound_s(cells):
    """The least time of Gotoh DP blocks of ``cells`` cells in all: a
    block of m members, a center of la and a member width of lb has m * la
    * lb."""
    return GOTOH_OPS_PER_CELL * cells / INT32_OPS_PER_S


def refine_bound_s(cells, member_columns):
    """The least time of refine DP passes of ``cells`` cells and
    ``member_columns`` in all: a pass of m members over C columns at a
    member width of lmax residues has m * C * lmax and m * C."""
    return (REFINE_OPS_PER_CELL * cells
            + REFINE_OPS_PER_COLUMN * member_columns) / FP32_OPS_PER_S

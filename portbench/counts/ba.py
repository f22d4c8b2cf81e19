"""The least time a Schur-PCG bundle-adjustment solve could take on the
card: the larger of its bytes at the HBM rate and its float32 operations
at the non-tensor-core rate (``counts.bound_s``), each counted as the
least that any implementation of the algorithm must do, so that a fused
kernel can approach the bound but not pass it.

A solve of O observations, C cameras and L points runs ``lm`` LM
iterations; each linearises once and applies the Schur operator S = H_cc -
W H_ll^-1 W^T ``cg`` times in its CG loop, and once more between the
right-hand side (W H_ll^-1 b_l) and the back-substitution (W^T dxi).

Bytes:
* a linearisation reads each observation's int32 camera and point index
  and its float32 (u, v): 16 B; the state (12 floats a pose, 3 a point) is
  read once and the candidate written once;
* a Schur apply reads each observation's two int32 indices: 8 B; a
  camera-space vector (6 floats a camera) is read and one written.  The
  per-observation Jacobians need not be stored (they can be recomputed
  from the indices, pixels and state), and the point-space vectors of an
  apply need not leave the chip, so neither is counted.

Operations, an add or a multiply each, counted from the products' nonzero
structure (d(u,v)/dp has two zeros; hat(p) three; symmetric blocks by
their unique entries):
* per observation and linearisation (``OPS_LINEARIZE``): the projection
  (R X + t 18, the division and the pixels 7, the residual 2), the Huber
  weight and its root 7, the Jacobians (d(u,v)/dp 7, through [I | -hat(p)]
  18, through R 18, whitening 20), the block sums (J_c^T J_c 21 entries x 4,
  J_l^T J_l 6 x 4, J_c^T r 6 x 4, J_l^T r 3 x 4), the preconditioner's
  correction (A = J_c^T J_l 18 x 3, A H_ll^-1 18 x 5, its product with A^T
  21 x 5 and the sum 21) and the candidate's cost (the projection 27, the
  Huber cost 6);
* per observation and Schur apply (``OPS_APPLY``): J_c v 22, J_l^T of it
  9 and the point sum 3; J_l y 10, J_c^T of it 18 and the camera sum 6;
* per point and apply, H_ll^-1 y (``OPS_APPLY_POINT``); per camera and CG
  iteration, H_cc p, the preconditioner and the vector updates
  (``OPS_CG_CAMERA``).
"""

from __future__ import annotations

from . import bound_s

BYTES_OBS_LINEARIZE = 16
BYTES_OBS_APPLY = 8
STATE_FLOATS = (12, 3)         # a pose, a point
CAMERA_VECTOR_FLOATS = 6

OPS_LINEARIZE = (27 + 7 + (7 + 18 + 18 + 20) + (84 + 24 + 24 + 12)
                 + (54 + 90 + 105 + 21) + (27 + 6))
OPS_APPLY = 22 + 9 + 3 + 10 + 18 + 6
OPS_APPLY_POINT = 15
OPS_CG_CAMERA = 66 + 66 + 72


def solve_bytes(O: int, C: int, L: int, lm: int, cg: int) -> float:
    state = 4 * (STATE_FLOATS[0] * C + STATE_FLOATS[1] * L)
    per_lm = BYTES_OBS_LINEARIZE * O + 2 * state
    per_apply = BYTES_OBS_APPLY * O + 2 * 4 * CAMERA_VECTOR_FLOATS * C
    return lm * (per_lm + (cg + 1) * per_apply)


def solve_ops(O: int, C: int, L: int, lm: int, cg: int) -> float:
    per_apply = OPS_APPLY * O + OPS_APPLY_POINT * L
    return lm * (OPS_LINEARIZE * O + (cg + 1) * per_apply + cg * OPS_CG_CAMERA * C)


def solve_bound_s(O: int, C: int, L: int, lm: int, cg: int):
    """Least seconds for one solve, and which of the two bounds it."""
    return bound_s(solve_bytes(O, C, L, lm, cg), solve_ops(O, C, L, lm, cg))


def bound_from_counters(c: dict):
    """Least seconds for the solves the program's ``ba_cg.*`` counters
    record (solves of one shape, as a cell's are), or None without them."""
    n = c.get("ba_cg.solves", 0)
    if not n:
        return None
    per = {k: c.get(f"ba_cg.{k}", 0) / n
           for k in ("observations", "cameras", "landmarks", "lm_iterations", "cg_iterations")}
    lm = per["lm_iterations"]
    cg = per["cg_iterations"] / lm if lm else 0
    return n * solve_bound_s(per["observations"], per["cameras"], per["landmarks"], lm, cg)[0]

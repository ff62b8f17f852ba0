"""Analytical per-CG-step compute/traffic model of the port's S.p.

Counterpart of `megba_tpu/analysis/edge_budget.py`, with its function
names and signatures: a DECLARED structural contract, priced from the
problem geometry, the edge stream and the dtypes, with no device in the
loop.

- ``flops_per_sp``    — useful floating-point work one shard performs
  per S.p product (one PCG iteration's matvec), MAC = 2 flops.
- ``bytes_touched_per_sp`` — device-memory bytes one shard reads and
  writes per S.p through the coupling kernels: coupling-row reads,
  Krylov gather/scatter traffic, block-diagonal reads, and the per-edge
  intermediates an unfused arm writes between two kernels and reads
  back.

Priced for the port's kernels (megba_tpu_torch/csrc):

- fused arms (kernels 7 and 8, ``transient_roundtrips=False``): gather,
  contraction and scatter in one kernel, no per-edge intermediate.
  Same layout as the JAX package's fused Pallas kernels: JAX's numbers.
- unfused EXPLICIT (kernel 5, the W contraction, kernel 4): the
  gathered operand rows [d_in, E] and the pre-reduction products
  [d_out, E] round-trip, cd + pd a slot a direction.  Same layout as
  JAX's unfused lowering: JAX's numbers.
- unfused IMPLICIT (kernel 2 then kernel 3): kernel 2 gathers x[seg(e)]
  itself and kernel 3 reduces J_outᵀu itself, so only the u rows
  [rd, E] round-trip, rd a slot a direction.  JAX's unfused lowering
  also materialises the gathered tiles and the products (cd + pd + rd
  a slot a direction): here the port's number is lower by
  2 * 2 * edge_slots * (cd + pd) * acc bytes.
- PGO (``pgo_sp_budget``, models/pgo.py): kernel 2 on each endpoint
  side, the j side's u permuted into the i side's order and summed,
  the sum permuted back, and kernel 3 on each side: the u rows make
  5 writes and 6 reads of rd elements a slot, where JAX prices one
  round-trip of the gathered pair, u and the products
  (2 * (4 * pose_dim + rd)).

``edge_slots`` is the shard's edge count as the kernels see it: the
port's CSR plans need no padding, so it is the real edge count of a
one-device or 1-D solve (JAX's padded stream count where the caller
passes it, the same formula either way).  Per-shard accounting, as in
JAX: the block-diagonal applies are counted at full Nc/Np.

Standard library only: importable by the audit CLI and the tests
without touching a device.
"""

from __future__ import annotations

from typing import Dict

# Operand storage widths the pricing understands (bytes per element).
OPERAND_BYTES: Dict[str, int] = {"bf16": 2, "f32": 4, "f64": 8}


def coupling_rows_per_edge(cd: int, pd: int, rd: int,
                           explicit: bool = False) -> int:
    """Stored coupling-row elements per edge slot (one direction's
    operand stream): the W block (explicit) or the Jc+Jp row pair
    (implicit)."""
    return cd * pd if explicit else rd * (cd + pd)


def coupling_macs_per_edge(cd: int, pd: int, rd: int,
                           explicit: bool = False) -> int:
    """MACs per edge slot per direction: W.p (explicit) or the two-stage
    J_outᵀ(J_in.p) contraction (implicit)."""
    return cd * pd if explicit else rd * (cd + pd)


def transient_elems_per_edge(cd: int, pd: int, rd: int,
                             explicit: bool = False) -> int:
    """Per-edge intermediate elements one unfused direction writes and
    reads back in the port's kernels: the gathered rows and the products
    on EXPLICIT (kernels 5 and 4 around the W contraction), the u rows
    alone on IMPLICIT (kernels 2 and 3 gather and reduce in-kernel)."""
    return cd + pd if explicit else rd


def schur_sp_budget(num_cameras: int, cd: int, num_points: int, pd: int,
                    rd: int, edge_slots: int, *,
                    explicit: bool = False,
                    operand: str = "f32",
                    param: str = "f32",
                    acc: str = "f32",
                    transient_roundtrips: bool = True,
                    lanes: int = 1) -> Dict[str, float]:
    """Per-shard, per-S.p budget of the Schur-complement matvec
    S.p = Hpp.p − Hpl.Hll⁻¹.Hlp.p on one edge-stream shard.

    ``operand`` prices the coupling rows (bf16 on the bf16 rung),
    ``param`` the parameter-space vectors and block diagonals, ``acc``
    the per-edge intermediates.  ``transient_roundtrips=False`` is the
    fused arm (kernels 7 and 8).  ``lanes`` scales everything for the
    lane-batched fleet program.
    """
    ob = OPERAND_BYTES[operand]
    pb = OPERAND_BYTES[param]
    ab = OPERAND_BYTES[acc]
    macs = coupling_macs_per_edge(cd, pd, rd, explicit)
    rows = coupling_rows_per_edge(cd, pd, rd, explicit)
    # Two coupling traversals per S.p (hlp: cam->pt, hpl: pt->cam), plus
    # the camera block-diagonal apply and the point-block Hll⁻¹ apply.
    flops = 2.0 * (num_cameras * cd * cd
                   + num_points * pd * pd
                   + 2 * edge_slots * macs)
    # Per-direction traffic: coupling rows read once; gather source and
    # scatter destination vectors touched once each at param width.
    vec_elems = num_cameras * cd + num_points * pd
    bytes_touched = 2.0 * (edge_slots * rows * ob + vec_elems * pb)
    # Block diagonals read once per apply (Hpp blocks + Hll⁻¹ blocks).
    bytes_touched += (num_cameras * cd * cd + num_points * pd * pd) * pb
    if transient_roundtrips:
        # Write + read of each per-edge intermediate, both directions.
        per_dir = transient_elems_per_edge(cd, pd, rd, explicit)
        bytes_touched += 2.0 * 2 * edge_slots * per_dir * ab
    return {"flops_per_sp": float(flops) * lanes,
            "bytes_touched_per_sp": float(bytes_touched) * lanes}


def pgo_sp_budget(num_poses: int, pose_dim: int, rd: int,
                  edge_slots: int, *,
                  param: str = "f64") -> Dict[str, float]:
    """Per-shard, per-H.x budget of PGO's matrix-free Gauss-Newton
    matvec: one edge-stream traversal computing Jᵀ(J.x) through the
    rd-row residual blocks (both endpoint Jacobians, pose_dim each),
    plus the block-Jacobi diagonal apply."""
    pb = OPERAND_BYTES[param]
    macs = rd * (2 * pose_dim)  # J.x per edge; same again for Jᵀu
    flops = 2.0 * (num_poses * pose_dim * pose_dim
                   + 2 * edge_slots * macs)
    rows = rd * 2 * pose_dim  # stored endpoint Jacobian pair per edge
    vec_elems = num_poses * pose_dim
    bytes_touched = (edge_slots * rows * pb + 2.0 * vec_elems * pb
                     + num_poses * pose_dim * pose_dim * pb)
    # The u rows between kernels 2 and 3 (models/pgo.py): u_i, u_j, the
    # permuted u_j, their sum and its permuted copy written (5 rd); u_j
    # for the permute, both addends, the sum twice (a reduce and the
    # permute) and the permuted sum read (6 rd).
    bytes_touched += 11.0 * edge_slots * rd * pb
    return {"flops_per_sp": float(flops),
            "bytes_touched_per_sp": float(bytes_touched)}

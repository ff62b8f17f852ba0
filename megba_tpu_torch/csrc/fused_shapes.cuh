// The shapes kernels 4-8 are compiled for: the one list.
//
//   MEGBA_COUPLING(cd, pd, od): a factor family's camera block of cd
//     parameters, point block of pd and od residual rows.  csrc/fused.cu
//     expands it into kernel 8 (fused_coupling_apply) at (d_in, d_out,
//     w_in_major) = (cd, pd, true) and (pd, cd, false), kernel 7
//     (fused_coupling_apply_implicit) at (d_in, d_out, od) = (cd, pd, od)
//     and (pd, cd, od), and kernel 6 (fused_block_diag_apply) at d = cd;
//     pd = 0 leaves kernels 7 and 8 out, od = 0 kernel 7.
//   MEGBA_WIDTH(F): the row count of kernels 4 and 5 (seg_reduce,
//     seg_expand) in csrc/segtiles.cu.
//
// An X-macro include: this file holds macro calls and comments only, and
// no include guard.  An includer defines both macros (one may expand to
// nothing) before the #include and #undefs them after; ops/fused.py and
// ops/segtiles.py read the same lines into SUPPORTED_DIRECTIONS,
// SUPPORTED_IMPLICIT, SUPPORTED_BLOCK_DIAG and SUPPORTED_WIDTHS.
//
// A library built with -DMEGBA_ONE_FUSED_CD=cd -DMEGBA_ONE_FUSED_PD=pd
// -DMEGBA_ONE_FUSED_OD=od holds that one MEGBA_COUPLING line instead, and
// no width: ops/fused.py builds one at first use for a shape outside the
// list (a Problem edge of the user's own widths), up to the cap it states.
//
// To add a shape: add its line here; the next build instantiates it in
// every precision arm.

#if defined(MEGBA_ONE_FUSED_CD)
MEGBA_COUPLING(MEGBA_ONE_FUSED_CD, MEGBA_ONE_FUSED_PD, MEGBA_ONE_FUSED_OD)
#else
MEGBA_COUPLING(9, 3, 2)   // bal
MEGBA_COUPLING(4, 2, 1)   // planar
MEGBA_COUPLING(7, 3, 2)   // rig (body)
MEGBA_COUPLING(12, 3, 2)  // pinhole_radial
MEGBA_COUPLING(6, 3, 6)   // pose_prior (dummy point)
MEGBA_COUPLING(6, 3, 2)   // a Problem edge on a 6-dof pose camera
MEGBA_WIDTH(1)
MEGBA_WIDTH(2)
MEGBA_WIDTH(3)
MEGBA_WIDTH(4)
MEGBA_WIDTH(5)
MEGBA_WIDTH(6)
MEGBA_WIDTH(7)
MEGBA_WIDTH(8)
MEGBA_WIDTH(9)
MEGBA_WIDTH(10)
MEGBA_WIDTH(11)
MEGBA_WIDTH(12)
MEGBA_WIDTH(13)
MEGBA_WIDTH(14)
MEGBA_WIDTH(15)
MEGBA_WIDTH(16)
#endif

// The (od, d) block shapes that kernels 1-3 of csrc/segtiles.cu
// (jtj_grad_reduce, coupling_expand, coupling_reduce) are compiled for:
// od residual rows, d parameters of the vertex block.  This is the one
// list: segtiles.cu expands MEGBA_BLOCK(od, d) into the dispatch of each
// of the three (an X-macro include, so this file holds macro calls and
// comments only, and no include guard), and ops/segtiles.py reads the
// same MEGBA_BLOCK lines into SUPPORTED_BLOCKS.
//
// A library built with -DMEGBA_ONE_BLOCK_OD=od -DMEGBA_ONE_BLOCK_D=d holds
// that one shape instead: ops/segtiles.py builds one at first use for a
// shape outside the list (a Problem edge of the user's own widths), up to
// the cap it states.
//
// To add a shape to the list: add its line here; the next build
// instantiates it in every precision arm.

#if defined(MEGBA_ONE_BLOCK_OD) && defined(MEGBA_ONE_BLOCK_D)
MEGBA_BLOCK(MEGBA_ONE_BLOCK_OD, MEGBA_ONE_BLOCK_D)
#else
MEGBA_BLOCK(2, 9)   // bal camera
MEGBA_BLOCK(2, 3)   // bal, rig, pinhole_radial, the 2-row Problem edges: point
MEGBA_BLOCK(1, 4)   // planar camera
MEGBA_BLOCK(1, 2)   // planar point
MEGBA_BLOCK(2, 7)   // rig body
MEGBA_BLOCK(2, 12)  // pinhole_radial camera
MEGBA_BLOCK(6, 6)   // pose_prior pose
MEGBA_BLOCK(6, 3)   // pose_prior (dummy) point
MEGBA_BLOCK(2, 6)   // a Problem edge on a 6-dof pose camera
MEGBA_BLOCK(7, 7)   // sim3_between pose (se3_between poses: (6, 6))
#endif

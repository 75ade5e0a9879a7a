// The fused gather + remap kernel's diploid family (ploidy 2, not mixed),
// in its three forms (see fused_gather_remap.cu): a translation unit of
// its own, which the build compiles beside the others at once.

#include "fused_gather_remap.cuh"

namespace gdb_fgr {
GDB_FGR_DIPLOID(GDB_FGR_DEFINE)
}  // namespace gdb_fgr

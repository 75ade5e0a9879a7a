// The fused gather + remap kernel's ploidy <= 2 family (mixed, or haploid),
// in its three forms (see fused_gather_remap.cu): a translation unit of
// its own, which the build compiles beside the others at once.

#include "fused_gather_remap.cuh"

namespace gdb_fgr {
GDB_FGR_PLOIDY2(GDB_FGR_DEFINE)
}  // namespace gdb_fgr

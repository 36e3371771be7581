// The fused BGPP decode's G = 8 template instances (compiled widths 16 to
// 256): bgpp_paged_attend.cu dispatches a launch here when its g needs
// them (or it takes the narrow loads or the workspace lists).

#include "bgpp_paged_attend_cluster.cuh"

int bgpp_cluster::run_g8(int DP, const Args& a) { return by_d<8>(DP, a); }

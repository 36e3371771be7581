// The fused BGPP decode's G = 2 template instances (compiled widths 16 to
// 256): bgpp_paged_attend.cu dispatches a launch here when its g needs
// them.

#include "bgpp_paged_attend_cluster.cuh"

int bgpp_cluster::run_g2(int DP, const Args& a) { return by_d<2>(DP, a); }

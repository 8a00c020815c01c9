// The stride set of the attention backward kernels, K2 (flash_bwd.cu) and
// K4 (flash_bwd_fused.cu): element strides of the (batch, time, head) axes
// of q, k, v, dO and the three gradients, each head dim contiguous.

#pragma once

namespace {

struct Strides {
  long long q[3], k[3], v[3], dout[3], dq[3], dk[3], dv[3];
};

// the 21 strides in the order q, k, v, dO, dq, dk, dv
inline Strides unpack_strides(const long long* s) {
  Strides st;
  long long* dst[7] = {st.q, st.k, st.v, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 7; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = s[3 * t + a];
  return st;
}

}  // namespace

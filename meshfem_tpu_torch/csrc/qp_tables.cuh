// The quadrature tables of kernel C, dN [Q, n, K1] and W [Q] in
// float32, one struct a configuration.  Written by
// meshfem_tpu_torch.kernels.qp.table_header() from
// sparse.contract.qp_tables; regenerate rather than edit:
//   python -c 'from meshfem_tpu_torch.kernels import qp; qp.TABLE_HEADER.write_text(qp.table_header())'
// The values are compile-time constants, so the compiler folds
// them into the instructions and the kernel drops the zero
// entries' terms.

#pragma once

namespace qp_tables {

template <int CFG>
struct Table;

// (dim, deg) = (3, 2): Q = 4, n = 10, K1 = 4; dN row (q, i) at (q n + i) K1
template <>
struct Table<0> {
  static constexpr int kDim = 3, kNodes = 10, kQ = 4;
  __host__ __device__ static constexpr float dN(int t) {
    constexpr float v[160] = {
        -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f,
        -0x1.2bbae2p-1f, -0x1.2bbae2p-1f, -0x1.2bbae2p-1f, 0x1.8330a8p-1f,
        0x1.1b06d2p-1f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.2bbae2p+1f, 0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.2bbae2p+1f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x1.2bbae2p+1f, 0x0.0p+0f, 0x1.1b06d2p-1f,
        -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.2bbae2p-1f, -0x1.2bbae2p-1f, 0x1.8330a8p-1f, -0x1.2bbae2p-1f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f,
        0x1.1b06d2p-1f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.2bbae2p+1f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.2bbae2p+1f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.2bbae2p+1f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.1b06d2p-1f,
        -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.2bbae2p-1f, 0x1.8330a8p-1f, -0x1.2bbae2p-1f, -0x1.2bbae2p-1f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f,
        0x1.2bbae2p+1f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.2bbae2p+1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.2bbae2p+1f,
        0x1.8330a8p-1f, -0x1.2bbae2p-1f, -0x1.2bbae2p-1f, -0x1.2bbae2p-1f,
        -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f, -0x1.1b06d2p-3f,
        -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.1b06d2p-3f, -0x1.2bbae2p-1f,
        0x1.1b06d2p-1f, 0x1.2bbae2p+1f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.1b06d2p-1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.2bbae2p+1f, 0x0.0p+0f,
        0x1.1b06d2p-1f, 0x0.0p+0f, 0x0.0p+0f, 0x1.2bbae2p+1f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.1b06d2p-1f, 0x1.1b06d2p-1f,
        0x0.0p+0f, 0x1.1b06d2p-1f, 0x0.0p+0f, 0x1.1b06d2p-1f,
    };
    return v[t];
  }
  __host__ __device__ static constexpr float W(int q) {
    constexpr float v[4] = {0x1.0p-2f, 0x1.0p-2f, 0x1.0p-2f, 0x1.0p-2f};
    return v[q];
  }
};

// (dim, deg) = (3, 1): Q = 1, n = 4, K1 = 4; dN row (q, i) at (q n + i) K1
template <>
struct Table<1> {
  static constexpr int kDim = 3, kNodes = 4, kQ = 1;
  __host__ __device__ static constexpr float dN(int t) {
    constexpr float v[16] = {
        0x1.0p+0f, 0x0.0p+0f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.0p+0f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x0.0p+0f, 0x0.0p+0f, 0x1.0p+0f,
    };
    return v[t];
  }
  __host__ __device__ static constexpr float W(int q) {
    constexpr float v[1] = {0x1.0p+0f};
    return v[q];
  }
};

// (dim, deg) = (2, 2): Q = 3, n = 6, K1 = 3; dN row (q, i) at (q n + i) K1
template <>
struct Table<2> {
  static constexpr int kDim = 2, kNodes = 6, kQ = 3;
  __host__ __device__ static constexpr float dN(int t) {
    constexpr float v[54] = {
        -0x1.0p-1f, -0x1.555556p-3f, -0x1.555556p-3f,
        -0x1.555556p-3f, -0x1.0p-1f, -0x1.555556p-3f,
        -0x1.555556p-1f, -0x1.555556p-1f, 0x1.0p+0f,
        0x1.555556p-1f, 0x1.555556p-1f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.555556p+1f, 0x1.555556p-1f,
        0x1.555556p+1f, 0x0.0p+0f, 0x1.555556p-1f,
        -0x1.0p-1f, -0x1.555556p-3f, -0x1.555556p-3f,
        -0x1.555556p-1f, 0x1.0p+0f, -0x1.555556p-1f,
        -0x1.555556p-3f, -0x1.555556p-3f, -0x1.0p-1f,
        0x1.555556p+1f, 0x1.555556p-1f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.555556p-1f, 0x1.555556p+1f,
        0x1.555556p-1f, 0x0.0p+0f, 0x1.555556p-1f,
        0x1.0p+0f, -0x1.555556p-1f, -0x1.555556p-1f,
        -0x1.555556p-3f, -0x1.0p-1f, -0x1.555556p-3f,
        -0x1.555556p-3f, -0x1.555556p-3f, -0x1.0p-1f,
        0x1.555556p-1f, 0x1.555556p+1f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.555556p-1f, 0x1.555556p-1f,
        0x1.555556p-1f, 0x0.0p+0f, 0x1.555556p+1f,
    };
    return v[t];
  }
  __host__ __device__ static constexpr float W(int q) {
    constexpr float v[3] = {0x1.555556p-2f, 0x1.555556p-2f, 0x1.555556p-2f};
    return v[q];
  }
};

// (dim, deg) = (2, 1): Q = 1, n = 3, K1 = 3; dN row (q, i) at (q n + i) K1
template <>
struct Table<3> {
  static constexpr int kDim = 2, kNodes = 3, kQ = 1;
  __host__ __device__ static constexpr float dN(int t) {
    constexpr float v[9] = {
        0x1.0p+0f, 0x0.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x1.0p+0f, 0x0.0p+0f,
        0x0.0p+0f, 0x0.0p+0f, 0x1.0p+0f,
    };
    return v[t];
  }
  __host__ __device__ static constexpr float W(int q) {
    constexpr float v[1] = {0x1.0p+0f};
    return v[q];
  }
};

}  // namespace qp_tables

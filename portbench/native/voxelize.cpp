// Host-side voxelizer — C++ twin of sessd_tpu/ops/voxelize.voxelize_np.
//
// First-come-first-serve binning with the same semantics as the reference's
// numba kernel (det3d/ops/point_cloud/point_cloud_ops_v2.py:9-63): points in
// order, new voxels claim slots until max_voxels, each voxel keeps its first
// max_points points. Used by the data-pipeline workers through ctypes
// (sessd_tpu/utils/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>

extern "C" {

int64_t voxelize(
    const float* points,        // [P, F]
    int64_t num_points,
    int64_t num_features,
    const float* pc_range,      // [6] x0 y0 z0 x1 y1 z1
    const float* voxel_size,    // [3] vx vy vz
    int64_t max_points,
    int64_t max_voxels,
    float* out_voxels,          // [max_voxels, max_points, F] (must be zeroed)
    int32_t* out_coords,        // [max_voxels, 3] (z, y, x)
    int32_t* out_num_points) {  // [max_voxels] (must be zeroed)
  const int64_t nx = (int64_t)std::llround((pc_range[3] - pc_range[0]) / voxel_size[0]);
  const int64_t ny = (int64_t)std::llround((pc_range[4] - pc_range[1]) / voxel_size[1]);
  const int64_t nz = (int64_t)std::llround((pc_range[5] - pc_range[2]) / voxel_size[2]);

  std::unordered_map<int64_t, int32_t> slot;
  slot.reserve((size_t)max_voxels * 2);
  int64_t num_voxels = 0;

  for (int64_t p = 0; p < num_points; ++p) {
    const float* pt = points + p * num_features;
    int64_t cx = (int64_t)std::floor((pt[0] - pc_range[0]) / voxel_size[0]);
    int64_t cy = (int64_t)std::floor((pt[1] - pc_range[1]) / voxel_size[1]);
    int64_t cz = (int64_t)std::floor((pt[2] - pc_range[2]) / voxel_size[2]);
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz) continue;
    int64_t key = (cz * ny + cy) * nx + cx;
    auto it = slot.find(key);
    int32_t v;
    if (it == slot.end()) {
      if (num_voxels >= max_voxels) continue;
      v = (int32_t)num_voxels++;
      slot.emplace(key, v);
      out_coords[v * 3 + 0] = (int32_t)cz;
      out_coords[v * 3 + 1] = (int32_t)cy;
      out_coords[v * 3 + 2] = (int32_t)cx;
    } else {
      v = it->second;
    }
    int32_t n = out_num_points[v];
    if (n < max_points) {
      std::memcpy(out_voxels + ((int64_t)v * max_points + n) * num_features,
                  pt, sizeof(float) * (size_t)num_features);
      out_num_points[v] = n + 1;
    }
  }
  return num_voxels;
}

}  // extern "C"

// Native env scheduling core (the C++ core of uav_bs_ctrl_tpu/native, as it is).
//
// Implements the hot inner loop of MultiUbsCoverageEnv._transmit_data —
// priority-ordered GT association with lowest-interference idle-RB selection
// and per-GT SINR rate computation (semantics of the reference's
// envs/mubs_cov/mubs_cov.py:172-200 "V2" scheduler) — as a small C library
// callable via ctypes.  The NumPy twin (_schedule_numpy) is the reference
// implementation; tests require exact schedules and rates within 1e-6.
//
// Build: python -m uav_bs_ctrl_tpu_torch.native.build (or at the env's first use)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// d_u2g:    [n_ubs, n_gts] float32 horizontal distances
// gain:     [n_ubs, n_gts] float64 channel gains
// mask_itf: [n_ubs, n_gts] uint8   (d <= r_cov)
// prior:    [n_gts]        int64   GT visit order
// out_sched:[n_ubs, n_gts, n_rbs] uint8
// out_rate_gt: [n_gts] float32 (Mbps)
// out_rate_ubs:[n_ubs] float32 (Mbps)
void schedule_and_rate(int n_ubs, int n_gts, int n_rbs,
                       const float* d_u2g, const double* gain,
                       const uint8_t* mask_itf, const int64_t* prior,
                       double r_cov, double p_tx, double noise, double bw,
                       uint8_t* out_sched, float* out_rate_gt,
                       float* out_rate_ubs) {
  std::vector<uint8_t> sched(static_cast<size_t>(n_ubs) * n_gts * n_rbs, 0);
  // p_itf[i][m][c]: interference power radiated by UBS i at GT m on RB c.
  std::vector<double> p_itf(static_cast<size_t>(n_ubs) * n_gts * n_rbs, 0.0);
  std::vector<int> used_rbs(n_ubs, 0);          // RBs currently assigned per UBS
  std::vector<uint8_t> rb_occupied(static_cast<size_t>(n_ubs) * n_rbs, 0);

  auto sched_at = [&](int i, int m, int c) -> uint8_t& {
    return sched[(static_cast<size_t>(i) * n_gts + m) * n_rbs + c];
  };
  auto itf_at = [&](int i, int m, int c) -> double& {
    return p_itf[(static_cast<size_t>(i) * n_gts + m) * n_rbs + c];
  };

  std::vector<int> order(n_ubs);
  std::vector<float> dcol(n_ubs);

  for (int pm = 0; pm < n_gts; ++pm) {
    const int m = static_cast<int>(prior[pm]);
    // UBSs sorted by distance to GT m (stable to match np.argsort ties).
    for (int i = 0; i < n_ubs; ++i) {
      order[i] = i;
      dcol[i] = d_u2g[static_cast<size_t>(i) * n_gts + m];
    }
    std::stable_sort(order.begin(), order.end(),
                     [&](int a, int b) { return dcol[a] < dcol[b]; });

    for (int oi = 0; oi < n_ubs; ++oi) {
      const int i = order[oi];
      if (used_rbs[i] < n_rbs &&
          static_cast<double>(dcol[i]) <= r_cov) {
        // Among idle RBs of UBS i, pick the one with the least total
        // interference at GT m.
        int best_c = -1;
        double best_itf = 0.0;
        for (int c = 0; c < n_rbs; ++c) {
          if (rb_occupied[static_cast<size_t>(i) * n_rbs + c]) continue;
          double itf = 0.0;
          for (int j = 0; j < n_ubs; ++j) itf += itf_at(j, m, c);
          if (best_c < 0 || itf < best_itf) {
            best_c = c;
            best_itf = itf;
          }
        }
        if (best_c >= 0) {
          sched_at(i, m, best_c) = 1;
          rb_occupied[static_cast<size_t>(i) * n_rbs + best_c] = 1;
          used_rbs[i] += 1;
          // UBS i now interferes on RB best_c with every GT in coverage
          // (except the served GT).
          for (int mm = 0; mm < n_gts; ++mm) {
            const size_t idx = static_cast<size_t>(i) * n_gts + mm;
            itf_at(i, mm, best_c) =
                mask_itf[idx] ? p_tx * gain[idx] : 0.0;
          }
          itf_at(i, m, best_c) = 0.0;
        }
        break;  // GT m handled (served or not); next GT.
      }
    }
  }

  // Rates: rate = bw * log2(1 + sinr) * 1e-6 (Mbps).
  std::memset(out_rate_gt, 0, sizeof(float) * n_gts);
  for (int m = 0; m < n_gts; ++m) {
    // Find the (single) serving link.
    for (int i = 0; i < n_ubs && out_rate_gt[m] == 0.0f; ++i) {
      for (int c = 0; c < n_rbs; ++c) {
        if (sched_at(i, m, c)) {
          double itf = 0.0;
          for (int j = 0; j < n_ubs; ++j) itf += itf_at(j, m, c);
          const double sinr =
              p_tx * gain[static_cast<size_t>(i) * n_gts + m] / (itf + noise);
          out_rate_gt[m] =
              static_cast<float>(bw * std::log2(1.0 + sinr) * 1e-6);
          break;
        }
      }
    }
  }

  for (int i = 0; i < n_ubs; ++i) {
    double acc = 0.0;
    for (int m = 0; m < n_gts; ++m) {
      int links = 0;
      for (int c = 0; c < n_rbs; ++c) links += sched_at(i, m, c);
      acc += links * static_cast<double>(out_rate_gt[m]);
    }
    out_rate_ubs[i] = static_cast<float>(acc);
  }

  std::memcpy(out_sched, sched.data(), sched.size());
}

}  // extern "C"

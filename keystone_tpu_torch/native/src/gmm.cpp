// Diagonal-covariance GMM EM fit + Fisher Vector encoding, host-native.
//
// Copy of keystone_tpu/native/src/gmm.cpp. Host counterpart of the port's
// GMM and Fisher encoder (keystone_tpu_torch/ops/learning/gmm.py,
// keystone_tpu_torch/ops/images/fisher.py) and the capability equivalent
// of the reference's enceval JNI kernel (reference: src/main/cpp/
// EncEval.cxx:1-194 computeGMM / calcAndGetFVs, OpenMP-parallel there
// too). Parameter layout at this ABI is cluster-major (k, d); the Python
// wrapper transposes from the framework's (d, k).
//
// FV math (Sanchez et al., as in ops/images/fisher.py):
//   s0 = mean_n q_nk ; s1 = X^T q / n ; s2 = (X*X)^T q / n
//   fv1 = (s1 - mu .* s0) / (sigma .* sqrt(w))
//   fv2 = (s2 - 2 mu .* s1 + (mu^2 - var) .* s0) / (var .* sqrt(2 w))

#include <algorithm>
#include <cmath>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// log-sum-exp-normalized, thresholded posteriors for one sample.
// means/vars: (k, d) cluster-major. Returns into q[k].
void posteriors(const float* x, int d, const float* means, const float* vars,
                const float* log_norm, int k, float weight_threshold,
                float* q) {
  float mx = -1e30f;
  for (int c = 0; c < k; ++c) {
    const float* mu = means + (size_t)c * d;
    const float* vr = vars + (size_t)c * d;
    double acc = 0.0;
    for (int j = 0; j < d; ++j) {
      const float diff = x[j] - mu[j];
      acc += (double)(diff * diff) / vr[j];
    }
    q[c] = log_norm[c] - 0.5f * (float)acc;
    mx = std::max(mx, q[c]);
  }
  float sum = 0.0f;
  for (int c = 0; c < k; ++c) {
    q[c] = std::exp(q[c] - mx);
    sum += q[c];
  }
  for (int c = 0; c < k; ++c) q[c] /= sum;
  float tsum = 0.0f;
  for (int c = 0; c < k; ++c) {
    if (q[c] <= weight_threshold) q[c] = 0.0f;
    tsum += q[c];
  }
  tsum = std::max(tsum, 1e-30f);
  for (int c = 0; c < k; ++c) q[c] /= tsum;
}

void compute_log_norm(const float* vars, const float* weights, int k, int d,
                      std::vector<float>& log_norm) {
  log_norm.resize(k);
  for (int c = 0; c < k; ++c) {
    double s = 0.0;
    for (int j = 0; j < d; ++j) s += std::log((double)vars[(size_t)c * d + j]);
    log_norm[c] = (float)(-0.5 * d * std::log(2.0 * M_PI) - 0.5 * s +
                          std::log((double)std::max(weights[c], 1e-30f)));
  }
}

}  // namespace

extern "C" {

// k-means++ seeding + EM. x: (n, d) row-major. Outputs cluster-major.
// Returns the number of EM iterations executed.
int ks_gmm_fit(const float* x, long long n, int d, int k, int max_iter,
               float tol, unsigned long long seed, float var_floor,
               float weight_threshold, float* means, float* vars,
               float* weights) {
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<long long> uidx(0, n - 1);

  // ---- k-means++ init of means
  std::vector<double> d2(n, 1e30);
  {
    long long first = uidx(rng);
    std::memcpy(means, x + first * d, sizeof(float) * d);
    for (int c = 1; c < k; ++c) {
      const float* prev = means + (size_t)(c - 1) * d;
      double total = 0.0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : total)
#endif
      for (long long i = 0; i < n; ++i) {
        double acc = 0.0;
        const float* xi = x + i * d;
        for (int j = 0; j < d; ++j) {
          const double diff = xi[j] - prev[j];
          acc += diff * diff;
        }
        d2[i] = std::min(d2[i], acc);
        total += d2[i];
      }
      std::uniform_real_distribution<double> u(0.0, total);
      double target = u(rng), run = 0.0;
      long long pick = n - 1;
      for (long long i = 0; i < n; ++i) {
        run += d2[i];
        if (run >= target) { pick = i; break; }
      }
      std::memcpy(means + (size_t)c * d, x + pick * d, sizeof(float) * d);
    }
  }

  // ---- init vars to the global variance, weights uniform
  std::vector<double> gmean(d, 0.0), gvar(d, 0.0);
  for (long long i = 0; i < n; ++i)
    for (int j = 0; j < d; ++j) gmean[j] += x[i * d + j];
  for (int j = 0; j < d; ++j) gmean[j] /= (double)n;
  for (long long i = 0; i < n; ++i)
    for (int j = 0; j < d; ++j) {
      const double diff = x[i * d + j] - gmean[j];
      gvar[j] += diff * diff;
    }
  for (int j = 0; j < d; ++j)
    gvar[j] = std::max(gvar[j] / (double)n, (double)var_floor);
  for (int c = 0; c < k; ++c) {
    weights[c] = 1.0f / (float)k;
    for (int j = 0; j < d; ++j) vars[(size_t)c * d + j] = (float)gvar[j];
  }

  // ---- EM
  std::vector<float> log_norm;
  double prev_ll = -1e300;
  int it = 0;
  const int nt =
#ifdef _OPENMP
      omp_get_max_threads();
#else
      1;
#endif
  std::vector<double> acc_w((size_t)nt * k), acc_m((size_t)nt * k * d),
      acc_v((size_t)nt * k * d), acc_ll(nt);
  for (; it < max_iter; ++it) {
    compute_log_norm(vars, weights, k, d, log_norm);
    std::fill(acc_w.begin(), acc_w.end(), 0.0);
    std::fill(acc_m.begin(), acc_m.end(), 0.0);
    std::fill(acc_v.begin(), acc_v.end(), 0.0);
    std::fill(acc_ll.begin(), acc_ll.end(), 0.0);

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
#ifdef _OPENMP
      const int t = omp_get_thread_num();
#else
      const int t = 0;
#endif
      std::vector<float> q(k);
      double* aw = acc_w.data() + (size_t)t * k;
      double* am = acc_m.data() + (size_t)t * k * d;
      double* av = acc_v.data() + (size_t)t * k * d;
#ifdef _OPENMP
#pragma omp for
#endif
      for (long long i = 0; i < n; ++i) {
        const float* xi = x + i * d;
        // responsibility + per-sample log-likelihood (pre-threshold softmax
        // denominator gives the LL; reuse posteriors for simplicity)
        float mx = -1e30f;
        for (int c = 0; c < k; ++c) {
          const float* mu = means + (size_t)c * d;
          const float* vr = vars + (size_t)c * d;
          double a2 = 0.0;
          for (int j = 0; j < d; ++j) {
            const float diff = xi[j] - mu[j];
            a2 += (double)(diff * diff) / vr[j];
          }
          q[c] = log_norm[c] - 0.5f * (float)a2;
          mx = std::max(mx, q[c]);
        }
        double sum = 0.0;
        for (int c = 0; c < k; ++c) sum += std::exp((double)q[c] - mx);
        acc_ll[t] += mx + std::log(sum);
        for (int c = 0; c < k; ++c) {
          const double r = std::exp((double)q[c] - mx) / sum;
          aw[c] += r;
          double* amc = am + (size_t)c * d;
          double* avc = av + (size_t)c * d;
          for (int j = 0; j < d; ++j) {
            amc[j] += r * xi[j];
            avc[j] += r * xi[j] * xi[j];
          }
        }
      }
    }
    // reduce across threads into thread 0
    for (int t = 1; t < nt; ++t) {
      for (int c = 0; c < k; ++c) acc_w[c] += acc_w[(size_t)t * k + c];
      for (size_t i = 0; i < (size_t)k * d; ++i) {
        acc_m[i] += acc_m[(size_t)t * k * d + i];
        acc_v[i] += acc_v[(size_t)t * k * d + i];
      }
      acc_ll[0] += acc_ll[t];
    }
    // M step
    for (int c = 0; c < k; ++c) {
      const double wsum = std::max(acc_w[c], 1e-10);
      weights[c] = (float)(wsum / (double)n);
      for (int j = 0; j < d; ++j) {
        const double mu = acc_m[(size_t)c * d + j] / wsum;
        means[(size_t)c * d + j] = (float)mu;
        const double v = acc_v[(size_t)c * d + j] / wsum - mu * mu;
        vars[(size_t)c * d + j] = (float)std::max(v, (double)var_floor);
      }
    }
    const double avg_ll = acc_ll[0] / (double)n;
    if (it > 0 && std::fabs(avg_ll - prev_ll) < tol) { ++it; break; }
    prev_ll = avg_ll;
  }
  (void)weight_threshold;
  return it;
}

// Fisher Vector encode: x (n, d); gmm params cluster-major (k, d);
// out (d, 2k) row-major — [fv1 | fv2] concatenated along the k axis.
void ks_fisher_encode(const float* x, long long n, int d, const float* means,
                      const float* vars, const float* weights, int k,
                      float weight_threshold, float* out) {
  std::vector<float> log_norm;
  compute_log_norm(vars, weights, k, d, log_norm);

  const int nt =
#ifdef _OPENMP
      omp_get_max_threads();
#else
      1;
#endif
  std::vector<double> s0((size_t)nt * k, 0.0), s1((size_t)nt * k * d, 0.0),
      s2((size_t)nt * k * d, 0.0);
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    std::vector<float> q(k);
    double* ts0 = s0.data() + (size_t)t * k;
    double* ts1 = s1.data() + (size_t)t * k * d;
    double* ts2 = s2.data() + (size_t)t * k * d;
#ifdef _OPENMP
#pragma omp for
#endif
    for (long long i = 0; i < n; ++i) {
      const float* xi = x + i * d;
      posteriors(xi, d, means, vars, log_norm.data(), k, weight_threshold,
                 q.data());
      for (int c = 0; c < k; ++c) {
        if (q[c] == 0.0f) continue;
        ts0[c] += q[c];
        double* c1 = ts1 + (size_t)c * d;
        double* c2 = ts2 + (size_t)c * d;
        for (int j = 0; j < d; ++j) {
          c1[j] += (double)q[c] * xi[j];
          c2[j] += (double)q[c] * xi[j] * xi[j];
        }
      }
    }
  }
  for (int t = 1; t < nt; ++t) {
    for (int c = 0; c < k; ++c) s0[c] += s0[(size_t)t * k + c];
    for (size_t i = 0; i < (size_t)k * d; ++i) {
      s1[i] += s1[(size_t)t * k * d + i];
      s2[i] += s2[(size_t)t * k * d + i];
    }
  }

  const double inv_n = 1.0 / (double)n;
  for (int c = 0; c < k; ++c) {
    const double m0 = s0[c] * inv_n;
    const double sw = std::sqrt((double)std::max(weights[c], 1e-30f));
    for (int j = 0; j < d; ++j) {
      const double mu = means[(size_t)c * d + j];
      const double vr = vars[(size_t)c * d + j];
      const double m1 = s1[(size_t)c * d + j] * inv_n;
      const double m2 = s2[(size_t)c * d + j] * inv_n;
      // out is (d, 2k): row j, cols [c] and [k + c]
      out[(size_t)j * 2 * k + c] =
          (float)((m1 - mu * m0) / (std::sqrt(vr) * sw));
      out[(size_t)j * 2 * k + k + c] =
          (float)((m2 - 2.0 * mu * m1 + (mu * mu - vr) * m0) /
                  (vr * std::sqrt(2.0) * sw));
    }
  }
}

}  // extern "C"

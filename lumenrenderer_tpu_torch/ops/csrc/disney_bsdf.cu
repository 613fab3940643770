// Kernel D: the Disney BSDF's evaluate and sample, one thread a ray.
// bsdf/disney.py and bsdf/common.py hold the contract and the eager twin;
// every device function here copies one function there, operation for
// operation, in the same order. The JAX package has no Pallas kernel here:
// XLA fuses `lumenrenderer_tpu/bsdf/disney.py` on its own. So this kernel
// replaces none; it replaces PyTorch's eager Disney, about 600 elementwise
// kernels a call that move some 7.6 kB a ray.
//
// What bounds it on an H100: bytes. evaluate reads wo, wi, the shading
// normal and tangent, base color, metallic, roughness, the front-face flag
// and the ten material columns 8-17 (109 B a ray) and writes f and pdf
// (16 B); sample reads u (16 B) in place of wi and writes wi, f, pdf and
// is_specular (29 B). At 2560x1440 a call moves 0.46 or 0.52 GB, 0.14 or
// 0.16 ms at 3.35 TB/s; the arithmetic, a few hundred operations a ray, is
// far under that. The design keeps every intermediate in registers, reads
// each input once through its own row and column strides (the surface
// data's columns are views of one gathered table: no copy is made), and
// computes only the lobes whose value the result depends on: the eager
// twin computes every lobe and selects with torch.where, whose unselected
// branch, NaN or not, never reaches the result.
//
// Numbers: float32 throughout, the same rounded operations as PyTorch's
// kernels: this file is built with -fmad=false (ops/build.py), so no
// product is fused into a sum that the twin rounds apart; division by a
// Python number is PyTorch's multiplication by its float reciprocal; sqrtf,
// rsqrtf, powf, logf, sinf and cosf are the precise functions PyTorch's
// kernels call; clamps let NaN through as torch.clamp does; a 3-vector's
// sum and the cross product follow PyTorch's CUDA kernels (sum3, cross).
// Near-specular lobes make f and pdf sensitive to the last bit of the half
// vector, so the order matters, not only the precision.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -o libdisney_bsdf.so disney_bsdf.cu
// Entries: disney_evaluate(), disney_sample(), plain C, each returns
// cudaGetLastError(). Both launch on the given stream, do not synchronise
// and allocate nothing.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int N_IN = 9;   // wo, wi or u, normal, tangent, base_color,
                          // metallic, roughness, front_face, mat_rows

constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI = 1.0f / PI_F;     // x / math.pi on a CUDA tensor
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float CC_SPAN = (float)(0.001 - 0.1);  // lerp(0.1, 0.001, t)

struct Inputs {
    const void* p[N_IN];
    long long rs[N_IN], cs[N_IN];   // row and column strides, in elements
};

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z)
{
    V3 r; r.x = x; r.y = y; r.z = z; return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b)
{
    return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b)
{
    return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s)
{
    return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }

// torch.clamp_min / torch.clamp: NaN passes through
__device__ __forceinline__ float cmin(float x, float lo)
{
    return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp(float x, float lo, float hi)
{
    if (x != x) return x;
    return fminf(fmaxf(x, lo), hi);
}

// (x * y).sum(-1) of two (R,3) tensors: the products rounded, then PyTorch's
// reduction over a last axis of 3 (two lanes: lane 0 sums x0 and x2, lane 1
// holds x1, then the lanes combine)
__device__ __forceinline__ float sum3(float a, float b, float c)
{
    return (a + c) + b;
}
__device__ __forceinline__ float dot(V3 a, V3 b)
{
    return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// torch.linalg.cross: a product fused into the difference, as nvcc
// compiles PyTorch's a*b - c*d
__device__ __forceinline__ float dop(float a, float b, float c, float d)
{
    return fmaf(a, b, -(c * d));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b)
{
    return v3(dop(a.y, b.z, a.z, b.y), dop(a.z, b.x, a.x, b.z),
              dop(a.x, b.y, a.y, b.x));
}
// vecmath.normalize
__device__ __forceinline__ V3 normalize(V3 v)
{
    const float vv = dot(v, v);
    return scale(v, vv > 1e-20f ? rsqrtf(cmin(vv, 1e-20f)) : 0.0f);
}
// vecmath.reflect(d, n) = d - 2 (d . n) n
__device__ __forceinline__ V3 reflect(V3 d, V3 n)
{
    return sub(d, scale(n, 2.0f * dot(d, n)));
}
__device__ __forceinline__ float luminance(V3 c)
{
    return (c.x * 0.2126f + c.y * 0.7152f) + c.z * 0.0722f;
}
// flipped into the upper hemisphere where its z is negative
__device__ __forceinline__ V3 upper(V3 h) { return h.z < 0.0f ? neg(h) : h; }

struct Frame { V3 t, b, n; };

__device__ __forceinline__ V3 to_local(V3 w, const Frame& f)
{
    return v3(dot(w, f.t), dot(w, f.b), dot(w, f.n));
}
__device__ __forceinline__ V3 to_world(V3 l, const Frame& f)
{
    return add(add(scale(f.t, l.x), scale(f.b, l.y)), scale(f.n, l.z));
}

// disney._frame, with vecmath.build_onb's tangent where the tangent
// degenerates
__device__ Frame shading_frame(V3 n, V3 tangent)
{
    const V3 t_raw = sub(tangent, scale(n, dot(tangent, n)));
    const float len2 = dot(t_raw, t_raw);
    V3 t;
    if (len2 > 1e-8f) {
        t = scale(t_raw, rsqrtf(cmin(len2, 1e-12f)));
    } else {
        const float s = n.z >= 0.0f ? 1.0f : -1.0f;
        const float a = (1.0f / (s + n.z)) * -1.0f;
        const float b = (n.x * n.y) * a;
        t = v3(s * (n.x * n.x) * a + 1.0f, s * b, -s * n.x);
    }
    Frame f;
    f.t = t;
    f.b = cross(n, t);
    f.n = n;
    return f;
}

// common.schlick_fresnel
__device__ __forceinline__ float schlick(float c)
{
    const float m = clamp(1.0f - c, 0.0f, 1.0f);
    return m * m * m * m * m;
}

// common.fresnel_dielectric(cos_i, eta)
__device__ float fresnel_dielectric(float cos_i, float eta)
{
    cos_i = clamp(cos_i, 0.0f, 1.0f);
    const float sin2_t = (1.0f - cos_i * cos_i) / cmin(eta * eta, 1e-8f);
    const float cos_t = sqrtf(cmin(1.0f - sin2_t, 0.0f));
    const float r_par = (eta * cos_i - cos_t) / cmin(eta * cos_i + cos_t, 1e-8f);
    const float r_perp = (cos_i - eta * cos_t)
                         / cmin(cos_i + eta * cos_t, 1e-8f);
    const float f = 0.5f * (r_par * r_par + r_perp * r_perp);
    return sin2_t >= 1.0f ? 1.0f : f;
}

// common.ggx_lambda, smith_g2 (isotropic)
__device__ float ggx_lambda(float cos_theta, float alpha)
{
    const float c = clamp(fabsf(cos_theta), 1e-6f, 1.0f);
    const float t2 = cmin(1.0f - c * c, 0.0f) / (c * c);
    return 0.5f * (sqrtf(1.0f + alpha * alpha * t2) + -1.0f);
}
__device__ float smith_g2(float cos_o, float cos_i, float alpha)
{
    return 1.0f / ((1.0f + ggx_lambda(cos_o, alpha)) + ggx_lambda(cos_i, alpha));
}

// common.gtr1_d
__device__ float gtr1_d(float nh, float alpha)
{
    const float a2 = clamp(alpha * alpha, 1e-6f, (float)(1.0 - 1e-6));
    const float d = (a2 - 1.0f) * nh * nh + 1.0f;
    const float v = (a2 - 1.0f) / cmin(logf(a2) * PI_F * d, 1e-12f);
    return nh > 0.0f ? v : 0.0f;
}

// common.ggx_d_aniso, ggx_lambda_aniso, smith_g1_aniso, smith_g2_aniso,
// ggx_vndf_pdf_aniso
__device__ float ggx_d_aniso(V3 h, float ax, float ay)
{
    const float qx = h.x / ax, qy = h.y / ay;
    const float e = (qx * qx + qy * qy) + h.z * h.z;
    const float v = 1.0f / cmin(ax * PI_F * ay * e * e, 1e-12f);
    return h.z > 0.0f ? v : 0.0f;
}
__device__ float lambda_aniso(V3 w, float ax, float ay)
{
    const float wz = clamp(fabsf(w.z), 1e-6f, 1.0f);
    const float px = ax * w.x, py = ay * w.y;
    const float a2t2 = (px * px + py * py) / (wz * wz);
    return 0.5f * (sqrtf(a2t2 + 1.0f) + -1.0f);
}
__device__ float vndf_pdf_aniso(V3 wo, V3 h, float ax, float ay)
{
    const float g1 = 1.0f / (lambda_aniso(wo, ax, ay) + 1.0f);
    const float v = g1 * ggx_d_aniso(h, ax, ay) * cmin(dot(wo, h), 0.0f)
                    / cmin(wo.z, 1e-6f);
    return wo.z > 0.0f ? v : 0.0f;
}

// One ray's inputs, from the surface data's rows.
struct Surface {
    V3 base_color, normal, tangent;
    float metallic, roughness;
    float subsurface, specular, spec_tint, anisotropic, sheen, sheen_tint,
        clearcoat, clearcoat_gloss, spec_trans, ior;
    bool front_face;
};

__device__ __forceinline__ float ldf(const Inputs& in, int k, long long i,
                                     int c)
{
    return static_cast<const float*>(in.p[k])[i * in.rs[k] + c * in.cs[k]];
}
__device__ __forceinline__ V3 ld3(const Inputs& in, int k, long long i)
{
    return v3(ldf(in, k, i, 0), ldf(in, k, i, 1), ldf(in, k, i, 2));
}

__device__ Surface load_surface(const Inputs& in, long long i)
{
    Surface s;
    s.normal = ld3(in, 2, i);
    s.tangent = ld3(in, 3, i);
    s.base_color = ld3(in, 4, i);
    s.metallic = ldf(in, 5, i, 0);
    s.roughness = ldf(in, 6, i, 0);
    s.front_face = static_cast<const unsigned char*>(in.p[7])[i * in.rs[7]]
                   != 0;
    s.subsurface = ldf(in, 8, i, 8);
    s.specular = ldf(in, 8, i, 9);
    s.spec_tint = ldf(in, 8, i, 10);
    s.anisotropic = ldf(in, 8, i, 11);
    s.sheen = ldf(in, 8, i, 12);
    s.sheen_tint = ldf(in, 8, i, 13);
    s.clearcoat = ldf(in, 8, i, 14);
    s.clearcoat_gloss = ldf(in, 8, i, 15);
    s.spec_trans = ldf(in, 8, i, 16);
    s.ior = ldf(in, 8, i, 17);
    return s;
}

// What every lobe shares: disney._lobe_probs, _alpha_aniso, _eta.
struct Shared {
    float p_diffuse, p_specular, p_clearcoat, p_transmission;
    float ax, ay, eta;
    V3 f0;
};

// disney._f0_color
__device__ V3 f0_color(const Surface& s)
{
    const float lum = cmin(luminance(s.base_color), 1e-8f);
    const float k = s.specular * 0.08f;
    const V3 c = s.base_color;
    const float dx = k * ((c.x / lum - 1.0f) * s.spec_tint + 1.0f);
    const float dy = k * ((c.y / lum - 1.0f) * s.spec_tint + 1.0f);
    const float dz = k * ((c.z / lum - 1.0f) * s.spec_tint + 1.0f);
    return v3(dx + (c.x - dx) * s.metallic, dy + (c.y - dy) * s.metallic,
              dz + (c.z - dz) * s.metallic);
}

__device__ Shared shared_terms(const Surface& s)
{
    Shared r;
    r.f0 = f0_color(s);
    const float base_lum = cmin(luminance(s.base_color), 1e-4f);
    const float w_diff = (1.0f - s.metallic) * (1.0f - s.spec_trans) * base_lum;
    const float w_spec = cmin(luminance(r.f0), 0.08f);
    const float w_cc = s.clearcoat * 0.25f;
    const float w_trans = (1.0f - s.metallic) * s.spec_trans * base_lum;
    const float inv = 1.0f / cmin(((w_diff + w_spec) + w_cc) + w_trans, 1e-8f);
    r.p_diffuse = w_diff * inv;
    r.p_specular = w_spec * inv;
    r.p_clearcoat = w_cc * inv;
    r.p_transmission = w_trans * inv;
    const float alpha = cmin(s.roughness * s.roughness, 1e-4f);
    const float aspect = sqrtf(1.0f - clamp(s.anisotropic, 0.0f, 1.0f) * 0.9f);
    r.ax = cmin(alpha / aspect, 1e-4f);
    r.ay = cmin(alpha * aspect, 1e-4f);
    r.eta = s.front_face ? 1.0f / s.ior : s.ior;
    return r;
}

__device__ __forceinline__ float cc_alpha(const Surface& s)
{
    return s.clearcoat_gloss * CC_SPAN + 0.1f;
}

// disney._eval_lobes on a ray with wi_l.z > 1e-6: f_reflect and the
// three reflection pdfs
__device__ void eval_reflection(const Surface& s, const Shared& sh, V3 wo_l,
                                V3 wi_l, V3* f, float* pdf_d, float* pdf_s,
                                float* pdf_c)
{
    const float cos_o = cmin(wo_l.z, 1e-6f);
    const float cos_i_c = cmin(wi_l.z, 1e-6f);
    const V3 h = upper(normalize(add(wo_l, wi_l)));
    const float oh = cmin(dot(wo_l, h), 0.0f);
    const float nh = cmin(h.z, 0.0f);
    const float ax = sh.ax, ay = sh.ay;

    const float fl = schlick(cos_i_c);
    const float fv = schlick(cos_o);
    const float rr = s.roughness * 2.0f * oh * oh;
    const float fd90 = rr + 0.5f;
    const float f_d = ((fd90 - 1.0f) * fl + 1.0f) * ((fd90 - 1.0f) * fv + 1.0f);
    const float fss = ((rr - 1.0f) * fl + 1.0f) * ((rr - 1.0f) * fv + 1.0f);
    const float ss = 1.25f * (fss * (1.0f / (cos_i_c + cos_o) - 0.5f) + 0.5f);
    const float diff_w = f_d + (ss - f_d) * s.subsurface;
    const float dw = (1.0f - s.metallic) * (1.0f - s.spec_trans);
    const float kd = diff_w * dw;
    const V3 c = s.base_color;
    const float lum = cmin(luminance(c), 1e-8f);
    const float sheen_w = s.sheen * dw;
    const float f_oh = schlick(oh);
    const float d = ggx_d_aniso(h, ax, ay);
    const float g2 = 1.0f / ((1.0f + lambda_aniso(wo_l, ax, ay))
                             + lambda_aniso(wi_l, ax, ay));
    const float denom = cmin(cos_o * 4.0f * cos_i_c, 1e-8f);
    const float spec = d * g2 / denom;
    const float ca = cc_alpha(s);
    const float d_cc = gtr1_d(nh, ca);
    const float g_cc = smith_g2(cos_o, cos_i_c, 0.25f);
    const float f_cc_s = f_oh * 0.96f + 0.04f;
    const float f_cc = s.clearcoat * 0.25f * d_cc * g_cc * f_cc_s / denom;

    // f_diffuse + f_sheen + f_spec + f_clearcoat, per channel
    const float cx[3] = {c.x, c.y, c.z};
    const float f0[3] = {sh.f0.x, sh.f0.y, sh.f0.z};
    float out[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float f_diffuse = cx[k] * INV_PI * kd;
        const float sheen_color = (cx[k] / lum - 1.0f) * s.sheen_tint + 1.0f;
        const float f_sheen = sheen_w * sheen_color * f_oh;
        const float fres = f0[k] + (1.0f - f0[k]) * f_oh;
        out[k] = ((f_diffuse + f_sheen) + fres * spec) + f_cc;
    }
    *f = v3(out[0], out[1], out[2]);
    *pdf_d = cos_i_c * INV_PI;
    const float q = cmin(oh * 4.0f, 1e-8f);
    *pdf_s = vndf_pdf_aniso(wo_l, h, ax, ay) / q;
    *pdf_c = d_cc * nh / q;
}

// disney._eval_transmission on a ray with wi_l.z < -1e-6
__device__ void eval_transmission(const Surface& s, const Shared& sh,
                                  V3 wo_l, V3 wi_l, V3* f, float* pdf_t)
{
    const float cos_o = cmin(wo_l.z, 1e-6f);
    const float cos_i = wi_l.z;
    const float eta = sh.eta;
    const V3 h = upper(normalize(add(wo_l, scale(wi_l, 1.0f / eta))));
    const float oh = dot(wo_l, h);
    const float ih = dot(wi_l, h);
    const float ax = sh.ax, ay = sh.ay;
    const float d = ggx_d_aniso(h, ax, ay);
    const float g2 = 1.0f / ((1.0f + lambda_aniso(wo_l, ax, ay))
                             + lambda_aniso(wi_l, ax, ay));
    const float f_r = fresnel_dielectric(fabsf(oh), 1.0f / eta);
    const float e = oh + ih / eta;
    const float denom = cmin(e * e, 1e-8f);
    const float jac = fabsf(ih) / denom * (1.0f / (eta * eta));
    const float f_t = (1.0f - f_r) * d * g2 * fabsf(oh) * jac
                      / cmin(cos_o * fabsf(cos_i), 1e-8f);
    const float w = (1.0f - s.metallic) * s.spec_trans;
    const float k = f_t * w;
    const V3 c = s.base_color;
    *f = v3(k * sqrtf(cmin(c.x, 1e-30f)), k * sqrtf(cmin(c.y, 1e-30f)),
            k * sqrtf(cmin(c.z, 1e-30f)));
    *pdf_t = vndf_pdf_aniso(wo_l, h, ax, ay) * jac * (1.0f - f_r);
}

// disney.evaluate after the frame: wo_raw = wo in the frame before the
// clamp, wi_l = wi in the frame
__device__ void evaluate_local(const Surface& s, const Shared& sh, V3 wo_raw,
                               V3 wi_l, V3* f_out, float* pdf_out)
{
    if (!(wo_raw.z > 1e-6f)) {        // valid_o: the result is 0, whatever
        *f_out = v3(0.0f, 0.0f, 0.0f);
        *pdf_out = 0.0f;
        return;
    }
    const V3 wo_l = v3(wo_raw.x, wo_raw.y, cmin(wo_raw.z, 1e-6f));
    V3 f_refl = v3(0.0f, 0.0f, 0.0f), f_trans = v3(0.0f, 0.0f, 0.0f);
    float pdf_d = 0.0f, pdf_s = 0.0f, pdf_c = 0.0f, pdf_t = 0.0f;
    if (wi_l.z > 1e-6f)
        eval_reflection(s, sh, wo_l, wi_l, &f_refl, &pdf_d, &pdf_s, &pdf_c);
    else if (wi_l.z < -1e-6f)
        eval_transmission(s, sh, wo_l, wi_l, &f_trans, &pdf_t);
    *f_out = add(f_refl, f_trans);
    *pdf_out = ((sh.p_diffuse * pdf_d + sh.p_specular * pdf_s)
                + sh.p_clearcoat * pdf_c) + sh.p_transmission * pdf_t;
}

// sampling.sample_ggx_vndf (Heitz 2018) with slopes (ax, ay)
__device__ V3 sample_vndf(V3 wo, float ax, float ay, float u0, float u1)
{
    ax = cmin(ax, 1e-4f);
    ay = cmin(ay, 1e-4f);
    const V3 vh = normalize(v3(wo.x * ax, wo.y * ay, wo.z * 1.0f));
    const float lensq = vh.x * vh.x + vh.y * vh.y;
    V3 t1;
    if (lensq > 1e-7f) {
        const float r = rsqrtf(cmin(lensq, 1e-7f));
        t1 = v3(-vh.y * r, vh.x * r, 0.0f * r);
    } else {
        t1 = v3(1.0f, 0.0f, 0.0f);
    }
    const V3 t2 = cross(vh, t1);
    const float r = sqrtf(u0);
    const float phi = TWO_PI * u1;
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = 0.5f * (vh.z + 1.0f);
    p2 = (1.0f - s) * sqrtf(cmin(1.0f - p1 * p1, 0.0f)) + s * p2;
    const float p3 = sqrtf(cmin(1.0f - p1 * p1 - p2 * p2, 0.0f));
    const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, p3));
    return normalize(v3(ax * nh.x, ay * nh.y, cmin(nh.z, 0.0f)));
}

__global__ void __launch_bounds__(THREADS)
evaluate_kernel(Inputs in, float* __restrict__ f, float* __restrict__ pdf,
                long long n)
{
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Surface s = load_surface(in, i);
    const Frame fr = shading_frame(s.normal, s.tangent);
    const V3 wo_raw = to_local(ld3(in, 0, i), fr);
    const V3 wi_l = to_local(ld3(in, 1, i), fr);
    const Shared sh = shared_terms(s);
    V3 fv;
    float p;
    evaluate_local(s, sh, wo_raw, wi_l, &fv, &p);
    f[3 * i] = fv.x;
    f[3 * i + 1] = fv.y;
    f[3 * i + 2] = fv.z;
    pdf[i] = p;
}

// lobe codes written where asked: the lobe drawn (0 diffuse, 1 specular,
// 2 clearcoat, 3 transmission), + 4 where the transmission lobe met total
// internal reflection, + 8 where it reflected
__global__ void __launch_bounds__(THREADS)
sample_kernel(Inputs in, float* __restrict__ wi_out, float* __restrict__ f,
              float* __restrict__ pdf, unsigned char* __restrict__ is_spec,
              unsigned char* __restrict__ lobe_out, long long n)
{
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const Surface s = load_surface(in, i);
    const Frame fr = shading_frame(s.normal, s.tangent);
    const V3 wo_raw = to_local(ld3(in, 0, i), fr);
    const V3 wo_l = v3(wo_raw.x, wo_raw.y, cmin(wo_raw.z, 1e-6f));
    const Shared sh = shared_terms(s);
    const float u0 = ldf(in, 1, i, 0), u1 = ldf(in, 1, i, 1);
    const float sel = ldf(in, 1, i, 2), u3 = ldf(in, 1, i, 3);
    const float c1 = sh.p_diffuse;
    const float c2 = c1 + sh.p_specular;
    const float c3 = c2 + sh.p_clearcoat;
    const bool pick_diffuse = sel < c1;
    const bool pick_spec = sel >= c1 && sel < c2;
    const bool pick_cc = sel >= c2 && sel < c3;
    const bool pick_trans = sel >= c3;

    // the specular draw feeds the transmission lobe and the Fresnel term of
    // the pdf's extra term on every ray
    const V3 m = sample_vndf(wo_l, sh.ax, sh.ay, u0, u1);
    const float f_r = fresnel_dielectric(fabsf(dot(wo_l, m)), 1.0f / sh.eta);
    const V3 d_in = neg(wo_l);
    V3 wi_l;
    int lobe;
    if (pick_diffuse) {
        lobe = 0;
        const float r = sqrtf(u0);
        const float phi = TWO_PI * u1;
        wi_l = v3(r * cosf(phi), r * sinf(phi), sqrtf(cmin(1.0f - u0, 0.0f)));
    } else if (pick_spec) {
        lobe = 1;
        wi_l = reflect(d_in, m);
    } else if (pick_cc) {
        lobe = 2;
        const float ca = cc_alpha(s);
        const float a2 = clamp(ca * ca, 1e-6f, (float)(1.0 - 1e-6));
        const float cos2 = (1.0f - powf(a2, 1.0f - u0)) / (1.0f - a2);
        const float cos_t = sqrtf(clamp(cos2, 0.0f, 1.0f));
        const float sin_t = sqrtf(cmin(1.0f - cos2, 0.0f));
        const float phi = TWO_PI * u1;
        wi_l = reflect(d_in, v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t));
    } else {
        // vecmath.refract(d_in, m, eta); the transmission lobe reflects
        // where u3 < F or on total internal reflection
        const float eta = sh.eta;
        const float cos_i = -dot(d_in, m);
        const float sin2_t = eta * eta * cmin(1.0f - cos_i * cos_i, 0.0f);
        const bool tir = sin2_t >= 1.0f;
        const bool do_reflect = u3 < f_r || tir;
        lobe = 3 + 4 * tir + 8 * do_reflect;
        if (do_reflect) {
            wi_l = reflect(d_in, m);
        } else {
            const float cos_t = sqrtf(cmin(1.0f - sin2_t, 0.0f));
            wi_l = normalize(add(scale(d_in, eta),
                                 scale(m, eta * cos_i - cos_t)));
        }
    }
    const V3 wi = to_world(wi_l, fr);
    V3 fv;
    float p;
    evaluate_local(s, sh, wo_raw, to_local(wi, fr), &fv, &p);
    // the Fresnel reflection off a transmissive microfacet looks like the
    // specular lobe: its probability is folded into the pdf
    const V3 h = upper(normalize(add(wo_l, wi_l)));
    const float oh = cmin(dot(wo_l, h), 0.0f);
    const float extra = vndf_pdf_aniso(wo_l, h, sh.ax, sh.ay)
                        / cmin(oh * 4.0f, 1e-8f);
    p = p + (wi_l.z > 0.0f ? sh.p_transmission * f_r * extra : 0.0f);

    wi_out[3 * i] = wi.x;
    wi_out[3 * i + 1] = wi.y;
    wi_out[3 * i + 2] = wi.z;
    f[3 * i] = fv.x;
    f[3 * i + 1] = fv.y;
    f[3 * i + 2] = fv.z;
    pdf[i] = p;
    is_spec[i] = (pick_spec || pick_cc || pick_trans) && s.roughness < 0.08f;
    if (lobe_out != nullptr) lobe_out[i] = (unsigned char)lobe;
}

bool read_inputs(Inputs* in, const void* const* ptrs,
                 const long long* strides)
{
    for (int k = 0; k < N_IN; ++k) {
        if (ptrs[k] == nullptr) return false;
        in->p[k] = ptrs[k];
        in->rs[k] = strides[2 * k];
        in->cs[k] = strides[2 * k + 1];
    }
    return true;
}

int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// ptrs: N_IN input pointers in the order above (wi in slot 1); strides:
// each input's row and column stride in elements. f (n,3) and pdf (n,)
// contiguous float32.
extern "C" int disney_evaluate(const void* const* ptrs,
                               const long long* strides, void* f, void* pdf,
                               long long n, void* stream)
{
    if (n == 0) return 0;
    Inputs in;
    if (!read_inputs(&in, ptrs, strides)) return cudaErrorInvalidValue;
    evaluate_kernel<<<blocks_for(n), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<float*>(f), static_cast<float*>(pdf), n);
    return cudaGetLastError();
}

// As disney_evaluate, with u (n,4) in slot 1; writes wi (n,3), f (n,3),
// pdf (n,), is_specular (n,) bool and, where `lobe` is not null, the lobe
// codes (n,) uint8.
extern "C" int disney_sample(const void* const* ptrs, const long long* strides,
                             void* wi, void* f, void* pdf, void* is_spec,
                             void* lobe, long long n, void* stream)
{
    if (n == 0) return 0;
    Inputs in;
    if (!read_inputs(&in, ptrs, strides)) return cudaErrorInvalidValue;
    sample_kernel<<<blocks_for(n), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        in, static_cast<float*>(wi), static_cast<float*>(f),
        static_cast<float*>(pdf), static_cast<unsigned char*>(is_spec),
        static_cast<unsigned char*>(lobe), n);
    return cudaGetLastError();
}

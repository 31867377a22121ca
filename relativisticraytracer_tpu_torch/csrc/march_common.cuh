// Shared __device__ ray generation, physics and sky addressing of the
// record, replay and fused march kernels.
//
// Record (record.cu), replay (replay.cu) and the fused march (march.cu)
// must march bitwise the same trajectory, and all must match the plain
// PyTorch versions
// (render/march.py, physics/, media/, core/ of this package, themselves
// transcriptions of relativisticraytracer_tpu). So every function here is
// written op for op in the JAX package's order, and the library is built
// with -fmad=false (no a*b+c contraction) and without --use_fast_math.
//
// Constants: every literal carries an f suffix (a bare literal is a double
// and would promote the math to fp64; the build scans the PTX and fails on
// any fp64 instruction other than sinf/cosf's own slow path, see
// ops/cuda_lib.py).
// Constants that the JAX package folds in double from Python floats (e.g.
// -1.5 * eh, (eh * 1.01) ** 2, the probe bounds) arrive precomputed in
// SceneConsts, rounded to float32 once on the host
// (ops/cuda_lib.scene_consts), so one build serves every scene. So do the
// four step sizes h = step_size * m and their h / 6: float32 products and
// quotients folded with numpy, the same IEEE round-to-nearest bits as the
// device's mul.rn.f32 / div.rn.f32, so no step divides.
#pragma once

#include <cstdint>

struct SceneConsts {
    // geodesics / integrator
    float eh;              // event_horizon
    float inside_r2;       // (eh*0.5)*(eh*0.5)
    float radial_k;        // -1.5*eh
    float spin_k;          // 2*spin_a*eh
    float spin_a;
    float spin_axis[3];
    float mass_pos[3];
    // march
    float capture_r2;      // (eh*1.01)**2
    float escape_r2;       // escape_radius**2
    float step_size;       // step_size_m
    // adaptive step sizes (render/march.adaptive_h) and h / 6 (rk4_step):
    // near the hole (m = 0.1), disk zone (0.3), cloud zone (0.5), else (1.0)
    float h_near, h_disk, h_cloud, h_far;
    float h6_near, h6_disk, h6_cloud, h6_far;
    float disk_zone_y;     // disk_h_m*5
    float disk_zone_r2;    // (disk_out_m+5)**2
    float cloud_zone_y;    // cloud_h_m*1.5
    float cloud_zone_r2;   // cloud_out_m**2
    // skip probes (media/densities.py)
    float disk_k2, disk_rlo2, disk_rhi2;
    float cloud_k2, cloud_rlo2, cloud_rhi2;
    // redshift
    float eh_101;          // eh*1.01
    float eh_1005;         // eh*1.005
    // disk
    float isco;
    float disk_out;
    float edge_start;      // disk_out*0.85
    float edge_width;      // disk_out - disk_out*0.85
    float disk_h;
    float disk_temp_ref;
    float disk_lum;
    float disk_opacity;
    // clouds
    float cloud_edge_w;    // disk_out*0.8 - disk_out
    float taper_w;         // (isco+5) - isco
    float cloud_h_half;    // cloud_h_m*0.5
    float cloud_lum;
    float cloud_opacity;
    // static flags
    int enable_disk;
    int enable_clouds;
    int has_spin;
    int has_mass_pos;
    int oct5;              // scene.octaves(5)
    int oct2;              // scene.octaves(2)
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 mul(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// core/vecmath.normalize: zero vector when |v| < 1e-6
__device__ __forceinline__ V3 normalize3(V3 v) {
    float mag = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
    bool small = mag < 1e-6f;
    float inv = 1.0f / (small ? 1.0f : mag);
    return small ? v3(0.0f, 0.0f, 0.0f) : v3(v.x * inv, v.y * inv, v.z * inv);
}

__device__ __forceinline__ float clip01(float t) { return fminf(fmaxf(t, 0.0f), 1.0f); }

// ---------------------------------------------------------------- camera
struct CamScalars {
    // [time, pos(3), forward(3), right(3), up(3), use_ld, ld_k, ca_eff]
    float s[16];
};

// Where a launch's pixels sit in the full image (the shard origin and
// strip maps of pallas_march._gen_tile_rays): local pixel (lx, ly) renders
// global pixel (x0 + X(lx), y0 + Y(ly)) of an img_w x img_h frame, where
// Y(r) = (r / sh) * ystride + r % sh with row strips (sh > 0) and Y(r) = r
// without (sh = 0); X likewise with (sw, xstride). Integer-valued float
// adds below 2^24 are exact, so a shard's rays are bitwise the full
// frame's. The identity (origin 0, no strips, the launch's own size) is a
// single-device frame.
struct RayGrid {
    float x0, y0;
    int img_w, img_h;
    int sh, ystride;
    int sw, xstride;
};

// render/camera.generate_rays for one pixel: uv by division (not a
// reciprocal), optional barrel pre-warp, NDC with aspect on u only,
// rd = normalize(forward + u*right + v*up), origin at the camera.
__device__ __forceinline__ void gen_ray(const CamScalars& cam, const RayGrid& g, int lx, int ly,
                                        V3& p, V3& v) {
    const float* s = cam.s;
    if (g.sh > 0) ly = (ly / g.sh) * g.ystride + ly % g.sh;
    if (g.sw > 0) lx = (lx / g.sw) * g.xstride + lx % g.sw;
    float uvx = ((float)lx + g.x0) / (float)g.img_w;
    float uvy = ((float)ly + g.y0) / (float)g.img_h;
    if (s[13] > 0.5f) {  // lens distortion (postfx.apply_lens_distortion)
        float tx = uvx - 0.5f, ty = uvy - 0.5f;
        float r2 = tx * tx + ty * ty;
        float f = 1.0f + r2 * s[14];
        uvx = tx * f + 0.5f;
        uvy = ty * f + 0.5f;
    }
    float aspect = (float)g.img_w / (float)g.img_h;
    float u = (uvx * 2.0f - 1.0f) * aspect;
    float vv = uvy * 2.0f - 1.0f;
    v = normalize3(v3(s[4] + u * s[7] + vv * s[10], s[5] + u * s[8] + vv * s[11],
                      s[6] + u * s[9] + vv * s[12]));
    p = v3(s[1], s[2], s[3]);
}

// ---------------------------------------------------------------- fastmath
// core/fastmath.atan2: degree-8 minimax polynomial, coefficients rounded
// to float32 (hex literals keep the rounding exact).
__device__ __forceinline__ float atan2_poly(float y, float x) {
    float ax = fabsf(x), ay = fabsf(y);
    float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
    float t = mn / fmaxf(mx, 1e-37f);
    float s = t * t;
    float acc = 0x1.806616p-9f;
    acc = acc * s + -0x1.0ce968p-6f;
    acc = acc * s + 0x1.6288aap-5f;
    acc = acc * s + -0x1.3587b0p-4f;
    acc = acc * s + 0x1.b4f0a4p-4f;
    acc = acc * s + -0x1.230b1ep-3f;
    acc = acc * s + 0x1.99788ap-3f;
    acc = acc * s + -0x1.5554d2p-2f;
    acc = acc * s + 0x1.000000p+0f;
    float a = acc * t;
    a = (ay > ax) ? (0x1.921fb6p+0f - a) : a;   // f32(pi/2)
    a = (x < 0.0f) ? (0x1.921fb6p+1f - a) : a;  // f32(pi)
    return (y < 0.0f) ? -a : a;
}

__device__ __forceinline__ float arcsin_poly(float x) {
    float xc = fminf(fmaxf(x, -1.0f), 1.0f);
    return atan2_poly(xc, sqrtf(fmaxf(1.0f - xc * xc, 0.0f)));
}

// ---------------------------------------------------------------- noise
__device__ __forceinline__ float frac_signed(float x) { return x - truncf(x); }

__device__ __forceinline__ float hash31(float px, float py, float pz) {
    float x = frac_signed(px * 0.1031f);
    float y = frac_signed(py * 0.1031f);
    float z = frac_signed(pz * 0.1031f);
    float d = x * (y + 33.33f) + y * (z + 33.33f) + z * (x + 33.33f);
    x = x + d;
    y = y + d;
    z = z + d;
    return frac_signed((x + y) * z);
}

__device__ __forceinline__ float lerpf_(float a, float b, float t) { return a + t * (b - a); }

static __device__ float noise3d(float px, float py, float pz) {
    float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
    float fx = px - ix, fy = py - iy, fz = pz - iz;
    float ux = fx * fx * (3.0f - 2.0f * fx);
    float uy = fy * fy * (3.0f - 2.0f * fy);
    float uz = fz * fz * (3.0f - 2.0f * fz);
    float n000 = hash31(ix + 0.0f, iy + 0.0f, iz + 0.0f);
    float n100 = hash31(ix + 1.0f, iy + 0.0f, iz + 0.0f);
    float n010 = hash31(ix + 0.0f, iy + 1.0f, iz + 0.0f);
    float n110 = hash31(ix + 1.0f, iy + 1.0f, iz + 0.0f);
    float n001 = hash31(ix + 0.0f, iy + 0.0f, iz + 1.0f);
    float n101 = hash31(ix + 1.0f, iy + 0.0f, iz + 1.0f);
    float n011 = hash31(ix + 0.0f, iy + 1.0f, iz + 1.0f);
    float n111 = hash31(ix + 1.0f, iy + 1.0f, iz + 1.0f);
    float front = lerpf_(lerpf_(n000, n100, ux), lerpf_(n010, n110, ux), uy);
    float back = lerpf_(lerpf_(n001, n101, ux), lerpf_(n011, n111, ux), uy);
    return lerpf_(front, back, uz);
}

static __device__ float fbm(float px, float py, float pz, int octaves) {
    float v = 0.0f;
    float a = 0.5f;
    for (int o = 0; o < octaves; ++o) {
        v = v + a * noise3d(px, py, pz);
        px = px * 2.05f + 10.0f;
        py = py * 2.05f + 10.0f;
        pz = pz * 2.05f + 10.0f;
        a *= 0.5f;  // powers of two: exact, as the JAX package's Python floats
    }
    return v;
}

// ---------------------------------------------------------------- physics
// physics/geodesics.geodesic_acc
__device__ __forceinline__ V3 geodesic_acc(const SceneConsts& c, V3 p, V3 v) {
    float r2 = p.x * p.x + p.y * p.y + p.z * p.z;
    bool inside = r2 < c.inside_r2;
    float lx = p.y * v.z - p.z * v.y;
    float ly = p.z * v.x - p.x * v.z;
    float lz = p.x * v.y - p.y * v.x;
    float l2 = lx * lx + ly * ly + lz * lz;
    float inv_r = rsqrtf(fmaxf(r2, 1e-12f));
    float inv_r2 = inv_r * inv_r;
    float inv_r5 = inv_r2 * inv_r2 * inv_r;
    float radial = c.radial_k * l2 * inv_r5;
    radial = inside ? 0.0f : radial;
    V3 a = v3(p.x * radial, p.y * radial, p.z * radial);
    if (c.has_spin) {
        float sx = c.spin_axis[0], sy = c.spin_axis[1], sz = c.spin_axis[2];
        float dx = sy * p.z - sz * p.y;
        float dy = sz * p.x - sx * p.z;
        float dz = sx * p.y - sy * p.x;
        float strength = c.spin_k * (inv_r2 * inv_r);
        strength = inside ? 0.0f : strength;
        a = v3(a.x + dx * strength, a.y + dy * strength, a.z + dz * strength);
    }
    return a;
}

__device__ __forceinline__ V3 recenter(const SceneConsts& c, V3 p) {
    if (!c.has_mass_pos) return p;
    return v3(p.x - c.mass_pos[0], p.y - c.mass_pos[1], p.z - c.mass_pos[2]);
}

// physics/integrators.rk4_step (stage order and sum order kept); h6 is
// h / 6, looked up with h (adaptive_h)
__device__ __forceinline__ void rk4_step(const SceneConsts& c, V3& p, V3& v, float h, float h6) {
    V3 p0 = p, v0 = v;
    V3 kv1 = geodesic_acc(c, recenter(c, p0), v0);
    V3 kp1 = v0;
    float h_half = h * 0.5f;
    V3 v2 = add(v0, mul(kv1, h_half));
    V3 kv2 = geodesic_acc(c, recenter(c, add(p0, mul(kp1, h_half))), v2);
    V3 kp2 = v2;
    V3 v3_ = add(v0, mul(kv2, h_half));
    V3 kv3 = geodesic_acc(c, recenter(c, add(p0, mul(kp2, h_half))), v3_);
    V3 kp3 = v3_;
    V3 v4 = add(v0, mul(kv3, h));
    V3 kv4 = geodesic_acc(c, recenter(c, add(p0, mul(kp3, h))), v4);
    V3 kp4 = v4;
    V3 kv_sum = add(kv1, add(mul(kv2, 2.0f), add(mul(kv3, 2.0f), kv4)));
    V3 kp_sum = add(kp1, add(mul(kp2, 2.0f), add(mul(kp3, 2.0f), kp4)));
    p = add(p0, mul(kp_sum, h6));
    v = add(v0, mul(kv_sum, h6));
}

// physics/geodesics.redshift_factor
static __device__ float redshift_factor(const SceneConsts& c, V3 p, V3 rv) {
    float r = sqrtf(p.x * p.x + p.y * p.y + p.z * p.z);
    bool dead = r < c.eh_101;
    float r_safe = fmaxf(r, c.eh_1005);
    float g_gravity = sqrtf(1.0f - c.eh / r_safe);
    float v_mag = 1.0f / (r_safe * sqrtf(r_safe) + c.spin_a);
    V3 gas = normalize3(v3(-p.z, 0.0f, p.x));
    float cos_theta = dot3(rv, gas);
    float gamma = 1.0f / sqrtf(1.0f - v_mag * v_mag);
    float g_doppler = 1.0f / (gamma * (1.0f - v_mag * cos_theta));
    return dead ? 0.0f : g_gravity * g_doppler;
}

// ---------------------------------------------------------------- march helpers
// render/march.media_zones
__device__ __forceinline__ void media_zones(const SceneConsts& c, V3 rel, float r2,
                                            bool& zd, bool& zc) {
    float abs_y = fabsf(rel.y);
    zd = (abs_y < c.disk_zone_y) && (r2 < c.disk_zone_r2);
    zc = (abs_y < c.cloud_zone_y) && (r2 < c.cloud_zone_r2);
}

// render/march.adaptive_h (for an active ray): the float32 product
// step_size * m, and h / 6, both folded on the host
__device__ __forceinline__ void adaptive_h(const SceneConsts& c, float r2, bool zd, bool zc,
                                           float& h, float& h6) {
    bool near_bh = r2 < 324.0f;  // 18.0 ** 2
    h = near_bh ? c.h_near : (zd ? c.h_disk : (zc ? c.h_cloud : c.h_far));
    h6 = near_bh ? c.h6_near : (zd ? c.h6_disk : (zc ? c.h6_cloud : c.h6_far));
}

// render/march.media_probes (for an active ray)
__device__ __forceinline__ void media_probes(const SceneConsts& c, V3 rel, bool zd, bool zc,
                                             bool& pd, bool& pc) {
    float r_cyl2 = rel.x * rel.x + rel.z * rel.z;
    float y2 = rel.y * rel.y;
    float y4 = y2 * y2;
    pd = c.enable_disk && zd && (y4 * r_cyl2 < c.disk_k2) && (r_cyl2 >= c.disk_rlo2) &&
         (r_cyl2 <= c.disk_rhi2);
    pc = c.enable_clouds && zc && ((y4 * y4 * y2) * r_cyl2 < c.cloud_k2) &&
         (r_cyl2 >= c.cloud_rlo2) && (r_cyl2 <= c.cloud_rhi2);
}

// ---------------------------------------------------------------- media
// render/march._disk_block; adds to emit (r, g, b) and opacity
static __device__ void disk_block(const SceneConsts& c, V3 rel, float r2, V3 vn, bool zd, float time,
                           float& er, float& eg, float& eb, float& op) {
    // media/densities.accretion_envelope
    float r = sqrtf(rel.x * rel.x + rel.z * rel.z);
    bool in_annulus = (r >= c.isco) && (r <= c.disk_out);
    if (!(zd && in_annulus)) return;  // d_disk = 0 -> not lit: adds exact zeros
    float safe_r = fmaxf(r, 1e-6f);
    float ef = 1.0f - (r - c.edge_start) / c.edge_width;
    float edge_falloff = (r > c.edge_start) ? ef * ef : 1.0f;
    float local_h = c.disk_h * sqrtf(c.isco / safe_r);
    float vertical = expf(-(rel.y * rel.y) / (2.0f * local_h * local_h + 1e-7f));
    float radial = powf(c.isco / safe_r, 0.4f);
    float envelope = vertical * radial * edge_falloff;
    // media/densities.accretion_streaks
    float phi = atan2_poly(rel.z, rel.x);
    float t_r = c.isco / safe_r;
    float omega = 3.5f * (t_r * sqrtf(t_r));
    float ang = phi - time * omega;
    float rx = r * cosf(ang), ry = rel.y * 4.0f, rz = r * sinf(ang);
    float evolution = time * 0.35f;
    float n = fbm(rx * 0.45f, ry * 0.45f + evolution, rz * 0.45f, c.oct5);
    float cloud = fmaxf(n - 0.32f, 0.0f);
    cloud = powf(cloud * 2.8f, 1.6f);
    cloud = fminf(cloud, 6.0f);
    float d_disk = envelope * (0.02f + 5.0f * cloud);
    if (!(d_disk > 0.001f)) return;
    float g = redshift_factor(c, rel, vn);
    // media/densities.disk_temperature at r = sqrt(r2)
    float rr = sqrtf(r2);
    float temp = (rr < c.isco) ? 0.0f
                               : c.disk_temp_ref * powf(fmaxf(rr, 1e-6f) / c.isco, -0.75f);
    float t_ratio = temp / c.disk_temp_ref;
    float t_norm = sqrtf(t_ratio);
    float g2 = g * g;
    float bol_i = (g2 * g2) * t_norm * d_disk * c.disk_lum;
    float color_t = g * powf(t_ratio, 0.4f) * 2.5f;
    er = er + 1.0f * bol_i;
    eg = eg + fminf(0.12f * color_t, 0.25f) * bol_i;
    eb = eb + fmaxf(0.01f * (color_t - 2.0f), 0.0f) * bol_i;
    op = op + d_disk * c.disk_opacity;
}

__device__ __forceinline__ float smoothstep_w(float e0, float w, float x) {
    float t = clip01((x - e0) / w);
    return t * t * (3.0f - 2.0f * t);
}

// media/densities.dust_strands
static __device__ float dust_strands(const SceneConsts& c, V3 rel, float r, float safe_r, float time) {
    float phi = atan2_poly(rel.z, rel.x);
    float t_r = c.isco / safe_r;
    float omega = t_r * sqrtf(t_r);
    float ang = phi - time * omega;
    float cx = r * 0.8f, cy = rel.y * 15.0f, cz = ang * 10.0f;
    float ax = cx * 0.15f, ay = cy * 0.15f, az = cz * 0.15f;
    float w1x = fbm(ax, ay, az, c.oct2);
    float w1y = fbm(ax + 1.0f, ay + 2.0f, az + 3.0f, c.oct2);
    float w1z = fbm(ax + 4.0f, ay + 5.0f, az + 6.0f, c.oct2);
    float bx = (cx + w1x * 3.0f) * 0.4f;
    float by = (cy + w1y * 3.0f) * 0.4f;
    float bz = (cz + w1z * 3.0f) * 0.4f;
    float w2x = fbm(bx, by, bz, c.oct2);
    float w2y = fbm(bx + 2.0f, by + 1.0f, bz + 0.0f, c.oct2);
    float w2z = fbm(bx + 0.0f, by + 3.0f, bz + 1.0f, c.oct2);
    float fx = cx + w2x * 1.5f, fy = cy + w2y * 1.5f, fz = cz + w2z * 1.5f;
    // ridge octaves, lacunarity 2.1; frequencies are the JAX package's
    // Python-double products 1, 2.1, 4.41, ... rounded to float32
    const float freq[5] = {0x1.000000p+0f, 0x1.0cccccp+1f, 0x1.1a3d70p+2f, 0x1.285a1cp+3f,
                           0x1.372b6ap+4f};
    float n = 0.0f;
    float amp = 1.0f;
    for (int o = 0; o < c.oct5; ++o) {
        float nv = noise3d(fx * freq[o], fy * freq[o], fz * freq[o]);
        float wisp = 1.0f - fabsf(nv * 2.0f - 1.0f);
        n = n + wisp * amp;
        amp *= 0.5f;
    }
    float strands = smoothstep_w(0.4f, 0.4f, n * 0.55f);  // smoothstep(0.4, 0.8, .)
    float s2 = strands * strands;
    strands = s2 * s2;
    float detail = fbm(fx * 4.0f, fy * 4.0f + time * 0.5f, fz * 4.0f, c.oct2);
    strands = strands * (0.6f + 0.4f * detail);
    return strands * 12.0f;
}

// render/march._cloud_block; adds to emit (r, g, b) and opacity
static __device__ void cloud_block(const SceneConsts& c, V3 rel, float r2, V3 vn, bool zc, float time,
                            float& er, float& eg, float& eb, float& op) {
    // media/densities.dust_base
    float r = sqrtf(rel.x * rel.x + rel.z * rel.z);
    bool in_annulus = (r >= c.isco) && (r <= c.disk_out);
    float safe_r = fmaxf(r, 1e-6f);
    float edge_falloff = smoothstep_w(c.disk_out, c.cloud_edge_w, r);
    float inner_taper = smoothstep_w(c.isco, c.taper_w, r);
    float local_h = c.cloud_h_half * powf(c.isco / safe_r, 0.2f);
    float vertical = expf(-(rel.y * rel.y) / (2.0f * local_h * local_h + 1e-7f));
    float base = vertical * edge_falloff * inner_taper;
    bool alive = base >= 0.001f;
    if (!(zc && in_annulus && alive)) return;  // d_cloud = 0: exact zeros
    float d_cloud = base * dust_strands(c, rel, r, safe_r, time);
    if (!(d_cloud > 0.001f)) return;
    float g = redshift_factor(c, rel, vn);
    float lighting = 0.5f + 3.0f * powf(c.isco / fmaxf(sqrtf(r2), c.isco), 1.2f);
    float cloud_i = d_cloud * c.cloud_lum * lighting;
    float t = clip01((g - 0.7f) / 0.6f);  // (1.3 - 0.7) rounds to 0.6f
    float shift = t * t * (3.0f - 2.0f * t);
    // (0.8-1.2), (1.1-0.8), (1.4-0.6) round to -0.4f, 0.3f, 0.8f
    er = er + 0.60f * cloud_i * (1.2f + shift * -0.4f);
    eg = eg + 0.65f * cloud_i * (0.8f + shift * 0.3f);
    eb = eb + 0.80f * cloud_i * (0.6f + shift * 0.8f);
    op = op + d_cloud * c.cloud_opacity;
}

// ---------------------------------------------------------------- sky
// render/skybox.sky_coords_from_uv: wrap-U, clamp-V, the sample at
// (u*W - 0.5, v*H - 0.5) -> flat quad index and bilinear fractions
__device__ __forceinline__ void sky_coords_from_uv(int h, int w, float tx, float ty, int& idx,
                                                   float& fx, float& fy) {
    float ux = (tx - floorf(tx)) * (float)w;
    float vy = clip01(ty) * (float)h;
    float xb = ux - 0.5f;
    float yb = vy - 0.5f;
    float x0 = floorf(xb);
    float y0 = floorf(yb);
    fx = xb - x0;
    fy = yb - y0;
    int x0i = (int)x0;
    x0i = x0i < 0 ? x0i + w : x0i;
    int yq = (int)y0 + 1;
    idx = yq * w + x0i;
}

// render/skybox.sky_coords of the normalized final velocity: per channel
// (r, g, b) the quad index and fractions, written to plane ch of the
// [3, n] outputs; `ca` is the effective chromatic-aberration offset.
__device__ __forceinline__ void write_sky_coords(V3 vel, float ca, int sky_h, int sky_w,
                                                 size_t n, size_t pix, int* idx_out,
                                                 float* fx_out, float* fy_out) {
    V3 d = normalize3(vel);
    float phi = atan2_poly(d.z, d.x);
    float theta = arcsin_poly(d.y);
    float ty = 0.5f - theta / 0x1.921fb6p+1f;  // PI = 3.1415926535
    const float offs[3] = {ca, 0.0f, -ca};
    for (int ch = 0; ch < 3; ++ch) {
        float tx = 0.5f + (phi + offs[ch]) / 0x1.921fb6p+2f;  // 2 * PI
        int idx;
        float fx, fy;
        sky_coords_from_uv(sky_h, sky_w, tx, ty, idx, fx, fy);
        idx_out[(size_t)ch * n + pix] = idx;
        fx_out[(size_t)ch * n + pix] = fx;
        fy_out[(size_t)ch * n + pix] = fy;
    }
}

"""Generate golden vectors from the REFERENCE implementation's own math.

Compiles the reference's host-compilable device headers
(/root/reference/include/tiny-cuda-nn/common_device.h, interp.h, the
losses/*.h and optimizers/adam.h __global__ kernels) on the CPU with a
~60-line CUDA shim (shim.h), runs them over deterministic inputs, and
packs everything into tests/golden/golden.npz. tests/test_golden.py then
asserts the JAX implementation agrees - exactly for integer/hash math,
fp32-tight elsewhere.

The kernel functions from losses/adam headers are sliced out textually at
generation time (those headers drag in the CUDA runtime); nothing from the
reference is committed to this repo except the resulting numeric data.

Usage: python scripts/golden/gen_golden.py [reference_root]
"""
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np

REF = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "/root/reference")
HERE = pathlib.Path(__file__).resolve().parent
OUT = HERE.parent.parent / "tests" / "golden" / "golden.npz"

LOSSES = [
    "l2", "relative_l2", "relative_l2_luminance", "l1", "relative_l1",
    "mape", "smape", "cross_entropy", "variance_is",
]


def extract_functions(path, names):
    """Slice out complete function definitions by name via brace counting."""
    src = path.read_text()
    out = []
    for name in names:
        m = re.search(rf"(template\s*<[^>]*>\s*)?(static\s+)?(inline\s+)?"
                      rf"__global__\s+void\s+{name}\s*\(", src)
        if m is None:
            m = re.search(rf"(template\s*<[^>]*>\s*)?(static\s+inline\s+)?"
                          rf"__device__\s+\w[\w<>,\s\*]*?\s{name}\s*\(", src)
        assert m, f"{name} not found in {path}"
        start = m.start()
        i = src.index("{", m.end() - 1)
        depth = 0
        while True:
            if src[i] == "{":
                depth += 1
            elif src[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        out.append(src[start : i + 1])
    return "\n\n".join(out)


MAIN_TEMPLATE = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "SHIM_H"
#define TCNN_MIN_GPU_ARCH 0
#include <tiny-cuda-nn/common_device.h>
using namespace tcnn;

// ---- extracted reference kernels (losses/*.h, optimizers/adam.h,
// ---- interp.h) - host-callable with the threadIdx stub looping below
EXTRACTED

static FILE* g_out;
static void emit(const char* name, char dtype, const void* data,
                 uint32_t n, uint32_t m) {
    uint32_t nl = (uint32_t)strlen(name);
    fwrite(&nl, 4, 1, g_out);
    fwrite(name, 1, nl, g_out);
    fwrite(&dtype, 1, 1, g_out);
    uint32_t dims[2] = {n, m};
    fwrite(dims, 4, 2, g_out);
    fwrite(data, 4, (size_t)n * m, g_out);
}

// deterministic splitmix64-style generator (echoed into the output, so the
// python side never reimplements it)
static uint64_t g_state = 0x9E3779B97F4A7C15ull;
static uint32_t randu32() {
    g_state = g_state * 6364136223846793005ull + 1442695040888963407ull;
    return (uint32_t)(g_state >> 33);
}
static float randf() { return (float)randu32() / 4294967296.0f; }

template <uint32_t D, HashType HT>
static void do_hashes(const char* name, const std::vector<uint32_t>& cells,
                      std::vector<uint32_t>& out) {
    uint32_t n = cells.size() / D;
    out.resize(n);
    for (uint32_t i = 0; i < n; i++) {
        uvec<D> p;
        for (uint32_t d = 0; d < D; d++) p[d] = cells[i * D + d];
        out[i] = grid_hash<D, HT>(p);
    }
    emit(name, 'u', out.data(), n, 1);
}

template <uint32_t D>
static void do_grid_index(const char* name, GridType gt, uint32_t size,
                          uint32_t res, const std::vector<uint32_t>& cells) {
    uint32_t n = cells.size() / D;
    std::vector<uint32_t> out(n);
    for (uint32_t i = 0; i < n; i++) {
        uvec<D> p;
        for (uint32_t d = 0; d < D; d++) p[d] = cells[i * D + d];
        out[i] = grid_index<D, HashType::CoherentPrime>(gt, size, res, p);
    }
    emit(name, 'u', out.data(), n, 1);
}

int main(int argc, char** argv) {
    g_out = fopen(argv[1], "wb");

    // ---- 1. hashes, D=2/3/4 x 4 types, mixed small + full-range cells ----
    for (uint32_t d = 2; d <= 4; d++) {
        std::vector<uint32_t> cells(64 * d);
        for (size_t i = 0; i < cells.size(); i++)
            cells[i] = (i % 2) ? randu32() : randu32() % 1024;
        char nm[64];
        snprintf(nm, 64, "hash_cells_d%u", d);
        emit(nm, 'u', cells.data(), 64, d);
        std::vector<uint32_t> out;
        if (d == 2) {
            do_hashes<2, HashType::Prime>("hash_prime_d2", cells, out);
            do_hashes<2, HashType::CoherentPrime>("hash_coherent_d2", cells, out);
            do_hashes<2, HashType::ReversedPrime>("hash_reversed_d2", cells, out);
            do_hashes<2, HashType::Rng>("hash_rng_d2", cells, out);
        } else if (d == 3) {
            do_hashes<3, HashType::Prime>("hash_prime_d3", cells, out);
            do_hashes<3, HashType::CoherentPrime>("hash_coherent_d3", cells, out);
            do_hashes<3, HashType::ReversedPrime>("hash_reversed_d3", cells, out);
            do_hashes<3, HashType::Rng>("hash_rng_d3", cells, out);
        } else {
            do_hashes<4, HashType::Prime>("hash_prime_d4", cells, out);
            do_hashes<4, HashType::CoherentPrime>("hash_coherent_d4", cells, out);
            do_hashes<4, HashType::ReversedPrime>("hash_reversed_d4", cells, out);
            do_hashes<4, HashType::Rng>("hash_rng_d4", cells, out);
        }
    }

    // ---- 2. grid_index incl. uint32 stride wraparound ----
    // (size, res) pairs: dense-small, hash-capped, wraparound-prone res
    {
        const uint32_t sizes[] = {296, 16384, 524288, 524288};
        const uint32_t ress[]  = {17, 128, 1024, 2097152};
        const uint32_t gts[]   = {1, 0, 0, 0};  // 1=Dense else Hash
        for (int cfg = 0; cfg < 4; cfg++) {
            for (uint32_t d = 2; d <= 4; d++) {
                std::vector<uint32_t> cells(64 * d);
                for (size_t i = 0; i < cells.size(); i++)
                    cells[i] = randu32() % (ress[cfg] + 2);
                char nm[64];
                snprintf(nm, 64, "gi_cells_c%d_d%u", cfg, d);
                emit(nm, 'u', cells.data(), 64, d);
                snprintf(nm, 64, "gi_out_c%d_d%u", cfg, d);
                GridType gt = gts[cfg] ? GridType::Dense : GridType::Hash;
                if (d == 2) do_grid_index<2>(nm, gt, sizes[cfg], ress[cfg], cells);
                if (d == 3) do_grid_index<3>(nm, gt, sizes[cfg], ress[cfg], cells);
                if (d == 4) do_grid_index<4>(nm, gt, sizes[cfg], ress[cfg], cells);
            }
        }
        emit("gi_sizes", 'u', sizes, 4, 1);
        emit("gi_ress", 'u', ress, 4, 1);
        emit("gi_types", 'u', gts, 4, 1);
    }

    // ---- 3. pos_fract (identity + smoothstep w/ derivatives) ----
    {
        const int N = 128;
        std::vector<float> xs(N), scales(N);
        for (int i = 0; i < N; i++) {
            xs[i] = randf() * 1.4f - 0.2f;  // incl. out-of-[0,1]
            scales[i] = (float)(1u << (randu32() % 16)) * 1.5f - 1.0f;
        }
        emit("pf_x", 'f', xs.data(), N, 1);
        emit("pf_scale", 'f', scales.data(), N, 1);
        std::vector<float> pos_i(N), pos_s(N), dpos_s(N);
        std::vector<uint32_t> grid_i(N), grid_s(N);
        for (int i = 0; i < N; i++) {
            pos_fract(xs[i], &pos_i[i], &grid_i[i], scales[i], identity_fun);
            pos_fract(xs[i], &pos_s[i], &dpos_s[i], &grid_s[i], scales[i],
                      smoothstep, smoothstep_derivative);
        }
        emit("pf_pos_identity", 'f', pos_i.data(), N, 1);
        emit("pf_grid_identity", 'u', grid_i.data(), N, 1);
        emit("pf_pos_smoothstep", 'f', pos_s.data(), N, 1);
        emit("pf_dpos_smoothstep", 'f', dpos_s.data(), N, 1);
        emit("pf_grid_smoothstep", 'u', grid_s.data(), N, 1);
    }

    // ---- 4. spherical harmonics (degrees 1..8) + input grads ----
    {
        const int N = 32;
        std::vector<float> dirs(N * 3);
        for (int i = 0; i < N * 3; i++) dirs[i] = randf();
        emit("sh_dirs", 'f', dirs.data(), N, 3);
        struct OutArr {
            float* p;
            float& operator()(uint32_t i) { return p[i]; }
            float operator()(uint32_t i) const { return p[i]; }
        };
        for (uint32_t deg = 1; deg <= 8; deg++) {
            std::vector<float> out(N * deg * deg, 0.f);
            std::vector<float> grad(N * 3, 0.f);
            std::vector<float> dl(deg * deg);
            for (uint32_t k = 0; k < deg * deg; k++) dl[k] = randf() - 0.5f;
            for (int i = 0; i < N; i++) {
                float x = dirs[i * 3] * 2 - 1, y = dirs[i * 3 + 1] * 2 - 1,
                      z = dirs[i * 3 + 2] * 2 - 1;
                OutArr oa{&out[i * deg * deg]};
                sh_enc<float>(deg, x, y, z, oa);
                OutArr da{dl.data()};
                vec3 g = sh_enc_grad<float>(deg, x, y, z, da);
                grad[i * 3] = g.x * 2; grad[i * 3 + 1] = g.y * 2;
                grad[i * 3 + 2] = g.z * 2;  // d(2x-1)/dx = 2
            }
            char nm[64];
            snprintf(nm, 64, "sh_out_deg%u", deg);
            emit(nm, 'f', out.data(), N, deg * deg);
            snprintf(nm, 64, "sh_dl_deg%u", deg);
            emit(nm, 'f', dl.data(), deg * deg, 1);
            snprintf(nm, 64, "sh_grad_deg%u", deg);
            emit(nm, 'f', grad.data(), N, 3);
        }
    }

    // ---- 5. oneblob quartic kernel CDF ----
    {
        const int N = 128;
        std::vector<float> xs(N), cdf(N), pdfv(N);
        for (int i = 0; i < N; i++) xs[i] = randf() * 4.0f - 2.0f;
        for (int i = 0; i < N; i++) {
            cdf[i] = quartic_cdf(xs[i], 0.1f);
            pdfv[i] = quartic_cdf_deriv(xs[i], 0.1f);
        }
        emit("qc_x", 'f', xs.data(), N, 1);
        emit("qc_cdf", 'f', cdf.data(), N, 1);
        emit("qc_pdf", 'f', pdfv.data(), N, 1);
    }

    // ---- 6. losses (float instantiation; stride 8 > dims 3; with pdf) ----
    {
        const uint32_t B = 32, dims = 3, stride = 8;
        const uint32_t n_elements = B * stride;
        std::vector<float> pred(n_elements), tgt(B * dims), pdf(B * dims);
        for (auto& v : pred) v = randf() * 2.0f + 0.05f;
        for (auto& v : tgt) v = randf() * 2.0f + 0.05f;
        for (auto& v : pdf) v = randf() + 0.5f;
        emit("loss_pred", 'f', pred.data(), B, stride);
        emit("loss_target", 'f', tgt.data(), B, dims);
        emit("loss_pdf", 'f', pdf.data(), B, dims);
        std::vector<float> values(n_elements), grads(n_elements);
        for (int use_pdf = 0; use_pdf < 2; use_pdf++) {
            const float* pp = use_pdf ? pdf.data() : nullptr;
            struct { const char* nm; int id; } kinds[] = {
                {"l2", 0}, {"relative_l2", 1}, {"relative_l2_luminance", 2},
                {"l1", 3}, {"relative_l1", 4}, {"mape", 5}, {"smape", 6},
                {"cross_entropy", 7}, {"variance_is", 8},
            };
            for (auto& k : kinds) {
                for (uint32_t t = 0; t < n_elements; t++) {
                    threadIdx.x = t;
                    switch (k.id) {
                        case 0: l2_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 1: relative_l2_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 2: relative_l2_luminance_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 3: l1_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 4: relative_l1_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 5: mape_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 6: smape_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 7: cross_entropy_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                        case 8: variance_is_loss<float>(n_elements, stride, dims, 1.0f, pred.data(), tgt.data(), values.data(), grads.data(), pp); break;
                    }
                }
                char nm[80];
                snprintf(nm, 80, "loss_%s_pdf%d_values", k.nm, use_pdf);
                emit(nm, 'f', values.data(), B, stride);
                snprintf(nm, 80, "loss_%s_pdf%d_grads", k.nm, use_pdf);
                emit(nm, 'f', grads.data(), B, stride);
            }
        }
        threadIdx.x = 0;
    }

    // ---- 7. Adam trajectory (reference kernel semantics) ----
    {
        const uint32_t n = 160, n_matrix = 96, steps = 40;
        const float loss_scale = 128.0f;
        std::vector<float> w_fp(n), m1(n, 0.f), m2(n, 0.f);
        std::vector<float> w_T(n), grad_T(n);
        std::vector<uint32_t> psteps(n, 0);
        for (auto& v : w_fp) v = randf() - 0.5f;
        emit("adam_w0", 'f', w_fp.data(), n, 1);
        std::vector<float> all_grads(steps * n);
        for (auto& v : all_grads) v = (randf() - 0.5f) * 2.0f;
        emit("adam_grads", 'f', all_grads.data(), steps, n);
        for (uint32_t i = 0; i < n; i++) w_T[i] = w_fp[i];
        for (uint32_t s = 0; s < steps; s++) {
            for (uint32_t i = 0; i < n; i++)
                grad_T[i] = all_grads[s * n + i] * loss_scale;
            for (uint32_t t = 0; t < n; t++) {
                threadIdx.x = t;
                adam_step<float>(
                    n, n_matrix,
                    /*relative_weight_decay=*/0.01f,
                    /*absolute_weight_decay=*/0.001f,
                    /*weight_clipping_magnitude=*/1.5f,
                    loss_scale,
                    /*learning_rate=*/1e-2f,
                    /*non_matrix_learning_rate_factor=*/0.5f,
                    true, true,
                    /*beta1=*/0.9f, /*beta2=*/0.99f, /*epsilon=*/1e-8f,
                    /*lower_lr_bound=*/0.0f, /*upper_lr_bound=*/1e30f,
                    /*l2_reg=*/1e-5f,
                    w_fp.data(), w_T.data(), grad_T.data(),
                    m1.data(), m2.data(), psteps.data());
            }
        }
        threadIdx.x = 0;
        emit("adam_w_final", 'f', w_fp.data(), n, 1);
        emit("adam_m1_final", 'f', m1.data(), n, 1);
        emit("adam_m2_final", 'f', m2.data(), n, 1);
    }

    // ---- 8. PPNG nlinear interpolation (interp.h) ----
    {
        const uint32_t D = 3, C = 2, R = 8, N = 16;
        std::vector<float> feats(R * R * R * C), sc(N * D);
        for (auto& v : feats) v = randf() - 0.5f;
        for (auto& v : sc) v = randf() * 2.0f - 1.0f;
        emit("ni_feats", 'f', feats.data(), R * R * R, C);
        emit("ni_sc", 'f', sc.data(), N, D);
        std::vector<float> out(C * N, 0.f);
        MatrixView<float> mv(out.data(), 1, C);  // row-major view [C x N]
        for (uint32_t b = 0; b < N; b++) {
            float s[D];
            for (uint32_t d = 0; d < D; d++) s[d] = sc[b * D + d];
            nlinear_interp<float, D, C>(feats.data(), R, s, mv, b, 0);
        }
        emit("ni_out", 'f', out.data(), N, C);
    }

    fclose(g_out);
    printf("golden raw written\n");
    return 0;
}
"""


def main():
    extracted = []
    for name in LOSSES:
        extracted.append(
            extract_functions(REF / "include/tiny-cuda-nn/losses" / f"{name}.h",
                              [f"{name}_loss"])
        )
    extracted.append(
        extract_functions(REF / "include/tiny-cuda-nn/optimizers/adam.h",
                          ["adam_step"])
    )
    extracted.append(
        extract_functions(REF / "include/tiny-cuda-nn/interp.h",
                          ["powu", "nlinear_interp"])
    )
    body = "namespace tcnn {\n" + "\n\n".join(extracted) + "\n}\n"
    main_cpp = MAIN_TEMPLATE.replace("EXTRACTED", body).replace(
        "SHIM_H", str(HERE / "shim.h")
    )

    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        (td / "main.cpp").write_text(main_cpp)
        subprocess.run(
            ["g++", "-std=c++17", "-O1",
             f"-I{REF}/include", f"-I{REF}/dependencies",
             str(td / "main.cpp"), "-o", str(td / "gen")],
            check=True,
        )
        raw = td / "golden.raw"
        subprocess.run([str(td / "gen"), str(raw)], check=True)
        data = raw.read_bytes()

    arrays = {}
    off = 0
    while off < len(data):
        (nl,) = np.frombuffer(data, np.uint32, 1, off); off += 4
        name = data[off : off + nl].decode(); off += nl
        dtype = chr(data[off]); off += 1
        n, m = np.frombuffer(data, np.uint32, 2, off); off += 8
        cnt = int(n) * int(m)
        dt = np.float32 if dtype == "f" else np.uint32
        arr = np.frombuffer(data, dt, cnt, off).reshape(int(n), int(m))
        off += cnt * 4
        arrays[name] = arr

    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} with {len(arrays)} arrays")


if __name__ == "__main__":
    main()

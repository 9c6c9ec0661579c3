"""The trace reading's pure parts: the class of a device operation by its
name, the busy union, and the readers' refusals."""
from bench import trace as TR


def test_kernel_class():
    # cuBLAS's Hopper GEMMs (program-level chip_smoke filed them as other)
    assert TR.kernel_class("nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT") \
        == "matmul"
    assert TR.kernel_class("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert TR.kernel_class("void fused_compress_kernel<4, 0, "
                           "__nv_bfloat16, false>(...)") == \
        "kernels (this repo)"
    assert TR.kernel_class("Memcpy DtoD (Device -> Device)") == \
        "dtype copies and memcpy"
    assert TR.kernel_class("void at::native::elementwise_kernel<128, 4, "
                           "direct_copy_kernel_cuda>") == \
        "dtype copies and memcpy"
    for k in ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkdv"):
        assert TR.kernel_class(f"void {k}_kernel<80>(Args)") == \
            "kernels (this repo)"
    assert TR.kernel_class("ncclDevKernel_AllGather_RING_LL") == "nccl"
    assert TR.kernel_class("void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::exp_kernel_cuda>") == \
        "other (elementwise, reductions, fills)"


def test_union_counts_overlap_once():
    assert TR._union([(5, 9), (0, 3), (2, 4), (8, 10)]) == [[0, 4], [5, 10]]


def summ(kernels):
    return {"busy_s": 0.5, "kernels": kernels, "ranges": {},
            "host_ranges": {}, "device_launches": 1}


def test_roofline_reads_only_whole_windows():
    ctx = {"kind": "train", "trace_units": 1, "accum": 1,
           "config": {"d_model": 1024, "n_heads": 8, "n_kv_heads": 8,
                      "head_dim": 128, "d_ff": 64, "vocab": 64,
                      "n_layers": 1},
           "traffic": {"sync": "loco", "loco_min_numel": 1 << 20},
           "peaks": {"hbm_bytes_per_s": 3.35e12}, "trace_window_s": 1.0}
    # one leaf reaches the minimum: wq, wk, wv, wo (1,048,576 each)
    n = 1 << 20
    ms = 1e3 * (n * 4.515625) / 3.35e12
    ctx["trace"] = summ({"fused_compress_kernel<4>": [4 * ms, 4]})
    assert abs(TR.kernel_roofline(ctx, "fused_compress", "compress")
               - 100.0) < 1e-9
    ctx["trace"] = summ({"fused_compress_kernel<4>": [4 * ms, 3]})
    assert TR.kernel_roofline(ctx, "fused_compress", "compress") is None
    ctx["traffic"]["sync"] = "fp"
    assert TR.kernel_roofline(ctx, "fused_compress", "compress") is None
    assert abs(TR.idle_share(ctx) - 50.0) < 1e-9

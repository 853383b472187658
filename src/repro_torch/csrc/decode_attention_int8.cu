// Single-token GQA attention against int8 KV caches with one fp32 scale per
// (slot, kv head): the entry point of the int8-cache form.  The kernel and
// its design are in decode_attention.cuh (C = int8_t), shared with the
// bf16 form's decode_attention.cu; a source of its own, so nvcc builds the
// two forms' 70 instantiations each in parallel.
#include "decode_attention.cuh"

// The int8-cache form: k, v int8 [B, W, Hkv, hd]; k_scale, v_scale fp32
// [B, W, Hkv, 1]; q and out fp32 or bf16 (dtype); the rest as
// decode_attention_launch's (decode_attention.cu).
extern "C" int decode_attention_int8_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, void* scratch,
    void* counters, int B, int H, int Hkv, int W, int hd, int splits,
    int chunk, float scale, int dtype, int fault, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, lengths, out, scratch, counters,
               B, Hkv, W, splits, chunk, scale, fault,
               static_cast<cudaStream_t>(stream)};
  return launch_dtype<true>(dtype, hd, H, a);
}

// Single-token GQA attention against a KV cache in q's dtype (fp32 or
// bf16): the entry point.  The kernel and its design are in
// decode_attention.cuh; the int8-cache form is decode_attention_int8.cu.
#include "decode_attention.cuh"

// scratch: B*Hkv*splits*G*(hd+2) fp32; counters: B*Hkv int32, all zero
// between calls (the merging block resets its own); fault 0 but for a
// planted fault.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* scratch,
                                       void* counters, int B, int H, int Hkv,
                                       int W, int hd, int splits, int chunk,
                                       float scale, int dtype, int fault,
                                       void* stream) {
  const Args a{q, k, v, nullptr, nullptr, lengths, out, scratch, counters,
               B, Hkv, W, splits, chunk, scale, fault,
               static_cast<cudaStream_t>(stream)};
  return launch_dtype<false>(dtype, hd, H, a);
}

// The whole decode step's layers kernel (decoder_layers.cuh) at widths
// that are no multiple of 16, for the C entries of decoder_step.cu: a
// source of its own, so that nvcc compiles its seven instantiations (one
// a cache kind) in parallel with decoder_step.cu's.

#include "decoder_layers.cuh"

namespace slimt {

int launch_padded_layers(int cache, const StepParams& p, const float* x, const float* c_in,
                         float* c_out, float* attn0, float* h_out, cudaStream_t stream) {
  return launch_layers<true>(cache, p, x, c_in, c_out, attn0, h_out, stream);
}

int padded_layers_capacity(int cache, int cs, size_t smem) {
  return layers_capacity<true>(cache, cs, smem);
}

}  // namespace slimt

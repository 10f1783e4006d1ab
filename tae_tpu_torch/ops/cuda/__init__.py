"""Wrappers of the hand-written CUDA kernels (counterpart of
``tae_tpu/ops/pallas/``). Each wrapper runs its plain PyTorch version for a
CPU tensor, launches its kernel for a CUDA tensor, and raises for anything
else; ``<wrapper>.launches`` counts its kernel launches."""


def counted() -> tuple:
    """Every wrapper that counts its launches (``<wrapper>.launches``)."""
    from tae_tpu_torch.ops.cuda.adamw import adamw_update
    from tae_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_fwd_lse,
        fused_qkv_attention, fused_qkv_attention_bwd,
        fused_qkv_attention_fwd_lse, fused_qkv_attention_i8)
    from tae_tpu_torch.ops.cuda.int4_block import int4_mlp
    from tae_tpu_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from tae_tpu_torch.ops.cuda.int8_block import int8_mlp, ln_quant
    from tae_tpu_torch.ops.cuda.int8_matmul import (int8_matmul_fused,
                                                    int8_matmul_rows)
    from tae_tpu_torch.ops.cuda.layernorm import (
        fused_layer_norm, fused_layer_norm_bwd, fused_layer_norm_fwd_stats)
    from tae_tpu_torch.ops.cuda.quantizer import nearest_code
    from tae_tpu_torch.ops.cuda.wide_attention import (
        fused_qkv_attention_q8, fused_qkv_attention_wide,
        fused_qkv_attention_wide_q8, fused_qkv_attention_wide_q8_2d)

    return (fused_layer_norm, fused_qkv_attention, ln_quant, int8_matmul_fused,
            int8_mlp, fused_qkv_attention_wide, fused_qkv_attention_q8,
            fused_qkv_attention_wide_q8, fused_qkv_attention_wide_q8_2d,
            fused_layer_norm_fwd_stats, fused_layer_norm_bwd,
            fused_qkv_attention_fwd_lse, fused_qkv_attention_bwd,
            int4_matmul_fused, int4_mlp, nearest_code, fused_qkv_attention_i8,
            flash_attention, flash_attention_fwd_lse, flash_attention_bwd,
            int8_matmul_rows, adamw_update)

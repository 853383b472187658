"""Step functions (train, prefill, batched prefill, decode, fused k-step
decode), AdamW and int8 error-feedback gradient compression."""

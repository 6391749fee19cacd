"""AdamW with bf16 or f32 moments and optional f32 master weights."""

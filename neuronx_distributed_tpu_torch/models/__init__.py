"""Model families (this slice: Llama)."""

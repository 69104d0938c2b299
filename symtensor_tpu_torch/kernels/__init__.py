from .poly_eval import poly_eval_flat, poly_eval_flat_batched, poly_eval_flat_fast

__all__ = ["poly_eval_flat", "poly_eval_flat_batched", "poly_eval_flat_fast"]

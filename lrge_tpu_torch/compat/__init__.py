from .rust_rand import ChaCha12Rng, unique_random_set, split_into_sets

__all__ = ["ChaCha12Rng", "unique_random_set", "split_into_sets"]

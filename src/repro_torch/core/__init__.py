"""The flat index and its search, on torch tensors."""

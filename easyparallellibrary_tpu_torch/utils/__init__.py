"""Small helpers of the PyTorch port."""

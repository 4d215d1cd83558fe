"""Farnebäck optical flow, flow warping, SSIM and the blur kernel (torch)."""

"""Metrics of the port: the auction EMD (kernel K7) and the alignment it
serves in training."""

from .emd_auction import align_clean_to_noisy, auction_emd, auction_emd_plain

__all__ = ["align_clean_to_noisy", "auction_emd", "auction_emd_plain"]

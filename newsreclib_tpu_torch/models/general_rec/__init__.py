"""Recommenders of the port."""
from newsreclib_tpu_torch.models.general_rec.nrms import NRMS

__all__ = ["NRMS"]

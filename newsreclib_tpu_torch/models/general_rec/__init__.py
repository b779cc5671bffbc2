"""Recommenders of the port."""
from newsreclib_tpu_torch.models.general_rec.caum import CAUM
from newsreclib_tpu_torch.models.general_rec.cen_news_rec import CenNewsRec
from newsreclib_tpu_torch.models.general_rec.mins import MINS
from newsreclib_tpu_torch.models.general_rec.nrms import NRMS

__all__ = ["CAUM", "CenNewsRec", "MINS", "NRMS"]

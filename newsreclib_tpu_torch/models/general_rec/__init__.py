"""Recommenders of the port."""
from newsreclib_tpu_torch.models.general_rec.caum import CAUM
from newsreclib_tpu_torch.models.general_rec.cen_news_rec import CenNewsRec
from newsreclib_tpu_torch.models.general_rec.dkn import DKN
from newsreclib_tpu_torch.models.general_rec.lstur import LSTUR
from newsreclib_tpu_torch.models.general_rec.miner import MINER
from newsreclib_tpu_torch.models.general_rec.mins import MINS
from newsreclib_tpu_torch.models.general_rec.naml import NAML
from newsreclib_tpu_torch.models.general_rec.npa import NPA
from newsreclib_tpu_torch.models.general_rec.nrms import NRMS
from newsreclib_tpu_torch.models.general_rec.tanr import TANR

__all__ = ["CAUM", "CenNewsRec", "DKN", "LSTUR", "MINER", "MINS", "NAML", "NPA", "NRMS", "TANR"]

"""The FairRec family (counterpart of ``newsreclib_tpu/models/fair_rec``):
SentiRec, SentiDebias and MANNeR's CR module, A-module and ensemble."""

from newsreclib_tpu_torch.models.fair_rec.manner import (
    MANNeRA,
    MANNeRCR,
    MANNeREnsemble,
    MANNeRNewsEncoder,
    aspect_module_scores,
    evaluate_ensemble,
    manner_ensemble_scores,
    supcon_embedding_loss,
    zscore_per_impression,
)
from newsreclib_tpu_torch.models.fair_rec.senti_debias import (
    SentiDebiasDiscriminator,
    SentiDebiasGenerator,
    SentiDebiasState,
    create_sentidebias_state,
    make_sentidebias_train_step,
)
from newsreclib_tpu_torch.models.fair_rec.sentirec import SentiRec

__all__ = [
    "MANNeRA",
    "MANNeRCR",
    "MANNeREnsemble",
    "MANNeRNewsEncoder",
    "SentiDebiasDiscriminator",
    "SentiDebiasGenerator",
    "SentiDebiasState",
    "SentiRec",
    "aspect_module_scores",
    "create_sentidebias_state",
    "evaluate_ensemble",
    "make_sentidebias_train_step",
    "manner_ensemble_scores",
    "supcon_embedding_loss",
    "zscore_per_impression",
]

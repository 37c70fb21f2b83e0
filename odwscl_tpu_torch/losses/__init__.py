from .mining import (StageAResult, StageBResult, assemble_bank, stage_a,
                     stage_b)
from .pseudo_labels import (PseudoLabels, mist_layer, od_layer,
                            oicr_layer)
from .supcon import supcon_loss, supcon_v2_loss
from .weak_loss import (avg_image_accuracy, mil_loss, refinement_cls_loss,
                        refinement_reg_loss, wsddn_final_score)

__all__ = [
    "StageAResult", "StageBResult", "stage_a", "stage_b", "assemble_bank",
    "PseudoLabels", "od_layer", "oicr_layer", "mist_layer", "supcon_loss",
    "supcon_v2_loss",
    "wsddn_final_score", "mil_loss", "refinement_cls_loss",
    "refinement_reg_loss", "avg_image_accuracy",
]

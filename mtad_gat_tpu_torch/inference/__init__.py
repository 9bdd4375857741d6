from mtad_gat_tpu_torch.inference.eval_methods import (
    adjust_predicts,
    bf_search,
    calc_point2point,
    calc_seq,
    epsilon_eval,
    find_epsilon,
    pot_eval,
)
from mtad_gat_tpu_torch.inference.online import OnlineScorer
from mtad_gat_tpu_torch.inference.online_fleet import OnlineFleetScorer
from mtad_gat_tpu_torch.inference.predictor import Predictor
from mtad_gat_tpu_torch.inference.spot import SPOT, biSPOT, bidSPOT, dSPOT

__all__ = [
    "adjust_predicts",
    "bf_search",
    "calc_point2point",
    "calc_seq",
    "epsilon_eval",
    "find_epsilon",
    "pot_eval",
    "OnlineFleetScorer",
    "OnlineScorer",
    "Predictor",
    "SPOT",
    "biSPOT",
    "bidSPOT",
    "dSPOT",
]

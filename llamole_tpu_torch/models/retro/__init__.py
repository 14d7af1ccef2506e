from .model import CostMLP, GraphPredictor, GraphPredictorConfig

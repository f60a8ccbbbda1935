from mfrec_tpu_torch.serving.server import RecommenderServer, serve

__all__ = ['RecommenderServer', 'serve']

from .zoo import char_rnn, mlp_mnist, sample_characters

__all__ = ["char_rnn", "mlp_mnist", "sample_characters"]

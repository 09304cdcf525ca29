from .zoo import char_rnn, sample_characters

__all__ = ["char_rnn", "sample_characters"]

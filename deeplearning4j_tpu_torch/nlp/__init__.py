"""Word vectors and text processing: the port of `deeplearning4j_tpu/nlp/`,
with the same modules, names and `__all__`. Tokenizers, iterators, the
vocabulary, bag-of-words, the inverted index and the Japanese lattice are
framework-free copies; the tables and their training run in PyTorch on the
device each entry point is given (the GPU unless `device="cpu"`)."""
from .tokenization import (CommonPreprocessor, DefaultTokenizer,
                           DefaultTokenizerFactory, EndingPreProcessor,
                           LowCasePreProcessor, NGramTokenizer,
                           NGramTokenizerFactory, Tokenizer, TokenizerFactory,
                           STOP_WORDS)
from .sentence_iterator import (BasicLabelAwareIterator, BasicSentenceIterator,
                                CollectionLabeledSentenceIterator,
                                CollectionSentenceIterator,
                                FileSentenceIterator, LabelAwareIterator,
                                LabelledDocument, LabelsSource,
                                LineSentenceIterator, SentenceIterator)
from .vocab import Huffman, VocabCache, VocabConstructor, VocabWord
from .embeddings import (InMemoryLookupTable, NegativeSampler,
                         WordVectorsModel)
from .word2vec import ParagraphVectors, SequenceVectors, Word2Vec
from .glove import CoOccurrences, Glove
from .serializer import WordVectorSerializer
from .bow import BagOfWordsVectorizer, TfidfVectorizer
from .invertedindex import InvertedIndex

__all__ = [
    "CommonPreprocessor", "DefaultTokenizer", "DefaultTokenizerFactory",
    "EndingPreProcessor", "LowCasePreProcessor", "NGramTokenizer",
    "NGramTokenizerFactory", "Tokenizer", "TokenizerFactory", "STOP_WORDS",
    "BasicLabelAwareIterator", "BasicSentenceIterator",
    "CollectionLabeledSentenceIterator", "CollectionSentenceIterator",
    "FileSentenceIterator", "LabelAwareIterator", "LabelledDocument",
    "LabelsSource", "LineSentenceIterator", "SentenceIterator",
    "Huffman", "VocabCache", "VocabConstructor", "VocabWord",
    "InMemoryLookupTable", "NegativeSampler", "WordVectorsModel",
    "ParagraphVectors", "SequenceVectors", "Word2Vec",
    "CoOccurrences", "Glove", "WordVectorSerializer",
    "BagOfWordsVectorizer", "TfidfVectorizer", "InvertedIndex",
]

"""Datasets of the port: DataSet and the iterators, the fetchers (the
bundled MNIST digits, Iris, Curves, and MNIST / CIFAR-10 / LFW over a local
cache), the record and image readers, LabeledPoint ingestion, the
asynchronous iterators and the input pipeline (padding, time buckets,
device prefetch, microbatch splitting)."""
from .fetchers import (CifarDataFetcher, CurvesDataFetcher, IrisDataFetcher,
                       LFWDataFetcher, MnistDataFetcher, augment_digits,
                       bundled_mnist_stratified, bundled_mnist_subset,
                       read_idx)
from .images import ImageLoader, ImageRecordDataSetIterator, ImageRecordReader
from .impl import (CifarDataSetIterator, IrisDataSetIterator,
                   MnistDataSetIterator)
from .iterators import (ArrayDataSetIterator, AsyncDataSetIterator,
                        AsyncMultiDataSetIterator, DataSet, DataSetIterator,
                        ExistingDataSetIterator, IteratorDataSetIterator,
                        ListDataSetIterator, MultiDataSet,
                        MultipleEpochsIterator, SamplingDataSetIterator)
from .labeled_point import (LabeledPoint, LabeledPointDataSetIterator,
                            labeled_points_to_dataset)
from .pipeline import (DevicePrefetchIterator, MicrobatchSplitIterator,
                       PadToBatchIterator, build_pipeline, pad_dataset,
                       split_microbatches)
from .records import (BinaryRecordDataSetIterator, BinaryRecordReader,
                      CSVRecordReader, RecordReaderDataSetIterator)

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "AsyncMultiDataSetIterator", "PadToBatchIterator",
           "DevicePrefetchIterator", "MicrobatchSplitIterator",
           "build_pipeline", "pad_dataset", "split_microbatches",
           "DataSet", "DataSetIterator",
           "ExistingDataSetIterator", "IteratorDataSetIterator",
           "ListDataSetIterator", "MultiDataSet", "MultipleEpochsIterator",
           "SamplingDataSetIterator", "bundled_mnist_subset",
           "bundled_mnist_stratified", "augment_digits", "read_idx",
           "MnistDataFetcher", "IrisDataFetcher", "CifarDataFetcher",
           "LFWDataFetcher", "CurvesDataFetcher", "MnistDataSetIterator",
           "IrisDataSetIterator", "CifarDataSetIterator", "ImageLoader",
           "ImageRecordReader", "ImageRecordDataSetIterator",
           "CSVRecordReader", "RecordReaderDataSetIterator",
           "BinaryRecordReader", "BinaryRecordDataSetIterator",
           "LabeledPoint", "LabeledPointDataSetIterator",
           "labeled_points_to_dataset"]

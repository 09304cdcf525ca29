from . import zoo
from .zoo import (alexnet, char_rnn, googlenet, lenet_mnist, mlp_mnist,
                  resnet50, sample_characters, vgg16, vgg19)

__all__ = ["zoo", "alexnet", "char_rnn", "googlenet", "lenet_mnist",
           "mlp_mnist", "resnet50", "sample_characters", "vgg16", "vgg19"]

from .zoo import (alexnet, char_rnn, lenet_mnist, mlp_mnist,
                  sample_characters, vgg16, vgg19)

__all__ = ["alexnet", "char_rnn", "lenet_mnist", "mlp_mnist",
           "sample_characters", "vgg16", "vgg19"]

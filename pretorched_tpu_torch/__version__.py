"""Version metadata of the PyTorch port (its own title and description;
the JAX package keeps ``pretorched_tpu/__version__.py``)."""

__title__ = 'pretorched_tpu_torch'
__description__ = ('PyTorch and CUDA (Hopper) pretrained model zoo for image, '
                   'video and audio: the port of pretorched_tpu.')
__url__ = 'https://github.com/distsys-graft/pretorched-tpu'
__version__ = '0.1.0'
__author__ = 'pretorched-tpu authors'
__license__ = 'MIT'

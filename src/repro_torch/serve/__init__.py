"""Serving stack of the port: the session client over the
continuous-batching engine, the prefix cache that dedups shared prompt
prefixes at admission, and the byte-level text front."""
from .api import ServeClient, Session
from .engine import Request, SamplingParams, ServingEngine, SpecConfig
from .prefix_cache import PrefixCache
from .tokenizer import ByteTokenizer
from ..obs import Obs

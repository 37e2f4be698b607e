"""Serving stack of the port: the session client over the
continuous-batching engine, and the byte-level text front."""
from .api import ServeClient, Session
from .engine import Request, SamplingParams, ServingEngine
from .tokenizer import ByteTokenizer

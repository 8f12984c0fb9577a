from .client import Client, MessageHandler

__all__ = ["Client", "MessageHandler"]

"""``python -m audiogpt_tpu_torch.serve`` — launch the chat app on the card
(see ``app.py``; counterpart of ``audiogpt_tpu/serve.py:1-6``)."""

from audiogpt_tpu_torch.app import main

if __name__ == "__main__":
    main()

"""Legacy 130-symbol vocabulary for the LSTM VAE stack.

Parity with reference/datasets/vas.py:154-208: code indices 0..127 map
to themselves, ``<s>`` = 128, ``</s>`` = 129.

The port's own copy of melspec_gpt_vqvae_tpu/data/vocab.py (numpy and the
standard library only): same classes, same batches for the same seed.
"""

from __future__ import annotations


class VocabEntry:
    def __init__(self, num_codes: int = 128):
        self.word2id = {"<s>": num_codes, "</s>": num_codes + 1}
        for i in range(num_codes):
            self.word2id[i] = i
        self.id2word_ = {v: k for k, v in self.word2id.items()}

    def __getitem__(self, word):
        return self.word2id[word]

    def __contains__(self, word):
        return word in self.word2id

    def __len__(self):
        return len(self.word2id)

    def add(self, word):
        if word not in self:
            wid = self.word2id[word] = len(self)
            self.id2word_[wid] = word
            return wid
        return self[word]

    def id2word(self, wid):
        return self.id2word_[wid]

    def decode_sentence(self, sentence):
        return [self.id2word_[int(w)] for w in sentence]

    @staticmethod
    def from_corpus(fname):
        vocab = VocabEntry()
        with open(fname) as f:
            for line in f:
                for word in line.split():
                    vocab.add(word)
        return vocab
